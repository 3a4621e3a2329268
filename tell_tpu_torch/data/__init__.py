"""The data path (counterparts of tell_tpu/data/): the byte-BPE tokenizer,
the readers and preprocess that turn article documents into npz shards,
fixed-shape bucketed batches and a host-to-device prefetcher."""
