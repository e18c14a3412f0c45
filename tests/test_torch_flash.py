"""The port's flash attention: its plain version against the JAX Pallas
kernel in interpret mode, over the cases of tests/test_flash.py and two at
Gemma3's head dimension of 256 (atol 2e-4, rtol 1e-3, that file's
tolerance), and the CPU dispatch rule. The
kernels themselves are held against the plain version on the card in
tests/test_torch_flash_card.py."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops.flash import flash_attention as jax_flash
from cake_tpu_torch.ops import flash

torch.set_num_threads(1)

# (name, b, sq, skv, hq, hkv, d, kwargs) — the cases of tests/test_flash.py
CASES = [
    ("causal_mha", 2, 256, 256, 4, 4, 32, {}),
    ("causal_gqa", 2, 256, 256, 4, 2, 32, {}),
    ("non_causal", 1, 128, 128, 2, 2, 16, dict(causal=False)),
    ("valid_len", 1, 128, 128, 2, 2, 16, dict(valid_len=70)),
    ("window", 1, 256, 256, 2, 2, 16, dict(window=48)),
    ("non_multiple", 1, 100, 100, 2, 2, 16, {}),
    ("append_q_offset", 1, 64, 256, 2, 2, 16,
     dict(valid_len=64, q_offset=70)),
    # Gemma3's head dimension and GQA group 4
    ("d256_g4_window", 1, 256, 256, 4, 1, 256, dict(window=96)),
    ("d256_g4_append", 1, 64, 256, 4, 1, 256,
     dict(valid_len=64, q_offset=100)),
]


def _inputs(rng, b, sq, skv, hq, hkv, d):
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_ref_matches_pallas_interpret(rng, case):
    name, b, sq, skv, hq, hkv, d, kw = case
    q, k, v = _inputs(rng, b, sq, skv, hq, hkv, d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True, block_q=64,
                                block_k=64, **kw))
    got = flash.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_cpu_tensor_takes_plain_version(rng):
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 64, 64, 4, 2, 16))
    before = flash.launch_counts()
    got = flash.flash_attention(q, k, v, valid_len=50)
    assert torch.equal(got, flash.flash_attention_ref(q, k, v, valid_len=50))
    assert flash.launch_counts() == before      # no kernel launch
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_attention_kernel(q, k, v)


def test_import_needs_no_nvcc():
    """Importing the op and the model stack neither builds nor loads the
    kernel library (the CPU test hosts have no nvcc)."""
    code = ("import sys, cake_tpu_torch.ops.flash, cake_tpu_torch.models\n"
            "assert 'cake_tpu_torch.kernels.build' not in sys.modules\n")
    env = {"PATH": "/nonexistent", "PYTHONPATH": ":".join(sys.path)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)

