"""The port's measurement tools (counterparts of the JAX package's
tools/kernel_variants.py, tools/longctx_variants.py and
tools/profile_decode.py), run as `python -m tell_tpu_torch.tools.<name>`.
Importing a module runs nothing."""
