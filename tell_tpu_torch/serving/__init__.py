"""HTTP caption service, micro-batched or through the continuous-batching
decode engine (counterpart of tell_tpu/serving/)."""
from .batcher import MicroBatcher
from .client import CaptioningClient, ClientError
from .encode_batcher import EncodeBatcher
from .engine import DecodeEngine
from .server import CaptionService, serve
