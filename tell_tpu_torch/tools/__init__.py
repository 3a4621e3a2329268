"""The port's tools, run as `python -m tell_tpu_torch.tools.<name>`: the
measurement tools (counterparts of the JAX package's
tools/kernel_variants.py, tools/longctx_variants.py and
tools/profile_decode.py), the tower converter, the quality loop and the
dataset build (get_articles_nytimes, process_images, detect_faces,
annotate_objects; counterparts of tools/ of the same names). Importing a
module runs nothing."""
