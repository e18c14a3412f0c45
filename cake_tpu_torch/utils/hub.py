"""Model names: a local directory or a Hugging Face repo id already in the
local cache (counterpart of cake_tpu/utils/hub.py: looks_like_repo_id,
hf_cache_dir, probe_cached_repo, resolve_model).

The port never downloads: the card's machine has no network and no
`huggingface_hub`. A repo id that is not in the cache raises with the
path that was probed.
"""
from __future__ import annotations

import os


def looks_like_repo_id(name: str) -> bool:
    """`org/name` that is not an existing path."""
    if os.path.exists(name):
        return False
    parts = name.split("/")
    return len(parts) == 2 and all(p and not p.startswith(".") for p in parts)


def hf_cache_dir() -> str:
    """The hub cache: $HF_HUB_CACHE, else $HF_HOME/hub, else
    ~/.cache/huggingface/hub."""
    return os.environ.get(
        "HF_HUB_CACHE",
        os.path.join(os.environ.get(
            "HF_HOME", os.path.expanduser("~/.cache/huggingface")), "hub"))


def _snapshots(repo_id: str) -> str:
    return os.path.join(hf_cache_dir(),
                        "models--" + repo_id.replace("/", "--"), "snapshots")


def probe_cached_repo(repo_id: str) -> str | None:
    """The newest snapshot of `repo_id` in the cache that holds weights
    (.safetensors or .gguf), or None."""
    snap_root = _snapshots(repo_id)
    if not os.path.isdir(snap_root):
        return None
    for s in sorted(os.listdir(snap_root), reverse=True):
        p = os.path.join(snap_root, s)
        if os.path.isdir(p) and any(f.endswith((".safetensors", ".gguf"))
                                    for f in os.listdir(p)):
            return p
    return None


def resolve_model(name_or_path: str) -> str:
    """A local directory -> itself; a repo id -> its cached snapshot.
    Raises FileNotFoundError otherwise."""
    if os.path.isdir(name_or_path):
        return name_or_path
    if not looks_like_repo_id(name_or_path):
        raise FileNotFoundError(f"model path {name_or_path!r} does not exist")
    cached = probe_cached_repo(name_or_path)
    if cached is None:
        raise FileNotFoundError(
            f"{name_or_path} is not in the local Hugging Face cache (probed "
            f"{_snapshots(name_or_path)}); the port does not download")
    return cached
