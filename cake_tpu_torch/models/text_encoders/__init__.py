"""Text encoders of the image models (counterpart of
cake_tpu/models/text_encoders/): CLIP and the T5 encoder."""
from .clip import (CLIPTextConfig, clip_mapping, clip_text_forward,
                   init_clip_params, tiny_clip_config)
from .t5 import (T5Config, init_t5_params, t5_encode, t5_mapping,
                 tiny_t5_config)

__all__ = [
    "CLIPTextConfig", "clip_mapping", "clip_text_forward", "init_clip_params",
    "tiny_clip_config", "T5Config", "init_t5_params", "t5_encode",
    "t5_mapping", "tiny_t5_config",
]
