"""Training (counterparts of tell_tpu/training/): BertAdam, the train step
(bf16 compute over fp32 master weights, NaN-batch skip), torch-format
checkpoints and the one-device Trainer with its train_from_shards entry
point."""
