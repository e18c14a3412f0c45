from .common import (FLAGSHIP_QWEN3_0_6B, ModelConfig, TextModel, Token,
                     config_from_hf_dict, init_cache, init_params,
                     tiny_config)
from .registry import (AUDIO_ARCHS, IMAGE_ARCHS, TEXT_FAMILIES,
                       modality_for_arch)
