"""Training: the configuration, the train/eval steps, the lazy table
optimizer, device-resident epochs, the host prefetcher, the SIGTERM guard
and the epoch loop (own copies of ``code2vec_tpu/train/{config,step,
table_opt,device_epoch,prefetch,preempt,loop}.py``)."""
