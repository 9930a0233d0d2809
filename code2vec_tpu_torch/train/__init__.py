"""Training: the configuration, the train/eval steps and the epoch loop
(own copies of ``code2vec_tpu/train/{config,step,loop}.py``)."""
