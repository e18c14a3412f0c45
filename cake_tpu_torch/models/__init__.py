from .common import (FLAGSHIP_QWEN3_0_6B, ModelConfig, TextModel, Token,
                     config_from_hf_dict, init_cache, init_params,
                     tiny_config)
