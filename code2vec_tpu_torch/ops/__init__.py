"""Ops of the forward: plain PyTorch versions and the Hopper kernels.

- ``attention`` — the plain masked attention pool (two formulations);
- ``quant`` — int8/bf16 table storage;
- ``embed`` — the forward row gather;
- ``backend`` — tensor device -> hand kernel or plain version, and the
  kernels' launch counts;
- ``pool_kernel`` — K1, the masked attention pool (``csrc/pool.cu``);
- ``fused_encode_pool`` — K2/K3, encode->attend->pool over gathered rows
  or with the gather inside (``csrc/fused_encode_pool.cu``).
"""
