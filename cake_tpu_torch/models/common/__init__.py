from .cache import init_cache, kv_capacity, update_kv_cache
from .config import (FLAGSHIP_QWEN3_0_6B, LayerSpec, ModelConfig,
                     config_from_hf_dict, tiny_config)
from .layers import (block_forward, embed_tokens, forward_layers, init_params,
                     lm_head_logits)
from .text_model import (TextModel, Token, bucket_for, check_prefill_bounds,
                         select_flash_mode)
