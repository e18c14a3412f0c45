"""Speech synthesis (counterpart of cake_tpu/models/audio/): VibeVoice (the
model, its checkpoint loader and the realtime 0.5B's config) and LuxTTS
(the Zipformer text encoder, the flow-matching decoder, the Vocos
vocoder, the phonemizer and its checkpoint loader)."""
from .luxtts import (LuxTTS, LuxTTSConfig, Phonemizer, luxtts_config_from_hf,
                     tiny_luxtts_config)
from .luxtts_loader import detect_luxtts_checkpoint, load_luxtts
from .vibevoice import (AudioOutput, VibeVoiceConfig, VibeVoiceTTS,
                        load_voice_prompt, tiny_tts_config,
                        vibevoice_config_from_hf)
from .vibevoice_loader import (detect_vibevoice_checkpoint, load_vibevoice,
                               realtime_0_5b_config)

__all__ = [n for n in dir() if not n.startswith("_")]
