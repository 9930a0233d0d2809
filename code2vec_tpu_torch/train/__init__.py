"""Training: the configuration, the train/eval steps, the lazy table
optimizer and the epoch loop (own copies of
``code2vec_tpu/train/{config,step,table_opt,loop}.py``)."""
