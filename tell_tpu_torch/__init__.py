"""tell_tpu_torch: the PyTorch + CUDA port of tell_tpu for NVIDIA Hopper.

Mirrors tell_tpu's layout and function names so each counterpart is easy
to find: ops/ (plain functions on tensors, same nested params dicts as the
JAX package, weights stored [in, out]), ops/kernels/ (hand-written CUDA
kernels beside their plain PyTorch versions, chosen by the tensor's
device), models/ (decoder, captioner, beam search, RoBERTa tower),
serving/ (micro-batched and continuous-batching HTTP caption service),
training/ (BertAdam, the train step, checkpoints, the Trainer), data/
(tokenizer, readers, preprocess, shards, bucketing), evalm/ (the caption
metrics), commands/ (`python -m tell_tpu_torch.commands`), config_io.py
(the expt/ YAMLs), tools/ (measurement tools, the quality loop) and
bridge.py (numpy <-> torch param trees and torch-side initialisers).

The package imports torch, numpy and the standard library; never jax,
nothing of tell_tpu (it keeps its own copies, config.py among them), and
neither `regex` nor PyYAML.
"""

__version__ = "0.1.0"
