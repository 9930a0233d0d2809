"""Ops of the forward: plain PyTorch versions and the Hopper kernels.

- ``attention`` — the plain masked attention pool (two formulations);
- ``quant`` — int8/bf16 table storage;
- ``embed`` — the forward row gather;
- ``backend`` — tensor device -> hand kernel or plain version, and the
  kernels' launch counts;
- ``pool_kernel`` — K1, the masked attention pool, and K1b, its backward
  (``csrc/pool.cu``), as one autograd Function;
- ``fused_encode_pool`` — K2/K3/K4, encode->attend->pool over gathered
  rows or with the gather inside, with the training keep mask
  (``csrc/fused_encode_pool.cu``); its backward recomputes the plain
  formulation.
"""
