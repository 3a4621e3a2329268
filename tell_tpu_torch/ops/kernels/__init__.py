"""Hand-written Hopper kernels for the hot ops, each beside its plain
PyTorch version: decode_attention.py (kernel A), encoder_attention.py
(kernel B), dynamic_conv.py (kernel C). `dispatch.py` holds the policy
(the tensor's device picks kernel or plain version), `build.py` compiles
csrc/*.cu at first launch."""
