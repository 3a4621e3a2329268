"""The training data path (counterparts of tell_tpu/data/records.py,
bucketing.py and prefetch.py): npz shards, fixed-shape bucketed batches and
a host-to-device prefetcher."""
