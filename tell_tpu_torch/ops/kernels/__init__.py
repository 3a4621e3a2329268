"""Hand-written Hopper kernels for the hot ops, each beside its plain
PyTorch version: decode_attention.py (kernels A and D: fp and int8/int4
K/V), encoder_attention.py (kernel B), dynamic_conv.py (kernel C),
topk_logits.py (kernel E), int8_linear.py (kernel G: the w8a8 GEMM).
`dispatch.py` holds the policy (the tensor's device picks kernel or plain
version), `build.py` compiles csrc/*.cu at first launch."""
