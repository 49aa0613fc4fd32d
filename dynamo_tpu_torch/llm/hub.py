"""Model resolution: local path, HF cache, or hub download.

A copy of ``resolve_model_path`` from ``dynamo_tpu/llm/hub.py`` (the
reference's launch/dynamo-run/src/hub.rs ``from_hf``). Resolution order:

  1. an existing local directory is returned as-is;
  2. a repo id already present in the local HF cache
     (``~/.cache/huggingface/hub``, or ``HF_HUB_CACHE`` / ``HF_HOME``)
     resolves to its pinned or newest snapshot;
  3. otherwise ``huggingface_hub.snapshot_download`` fetches config,
     tokenizer, and ``*.safetensors`` (``huggingface_hub`` is imported
     only here; ``HF_HUB_OFFLINE`` refuses the download).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

_NEEDED = ["*.safetensors*", "*.json", "*.model", "tokenizer*"]


def _cache_snapshot(repo_id: str, cache_dir: Optional[str] = None) -> Optional[str]:
    """Newest complete snapshot of ``repo_id`` in the local HF cache."""
    cache = cache_dir or os.path.expanduser(
        os.environ.get("HF_HUB_CACHE")
        or os.path.join(
            os.environ.get("HF_HOME", "~/.cache/huggingface"), "hub"
        )
    )
    repo_dir = os.path.join(
        os.path.expanduser(cache), f"models--{repo_id.replace('/', '--')}"
    )
    snaps = os.path.join(repo_dir, "snapshots")
    if not os.path.isdir(snaps):
        return None
    candidates = [
        os.path.join(snaps, s)
        for s in os.listdir(snaps)
        if os.path.isdir(os.path.join(snaps, s))
    ]
    # prefer the ref'd main revision when recorded, else newest mtime
    ref = os.path.join(repo_dir, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            pinned = os.path.join(snaps, f.read().strip())
        if os.path.isdir(pinned):
            return pinned
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def resolve_model_path(name_or_path: str, cache_dir: Optional[str] = None) -> str:
    """Local dir | cached snapshot | hub download -> a local directory."""
    if os.path.isdir(name_or_path):
        return name_or_path
    if "/" not in name_or_path or name_or_path.count("/") != 1:
        raise FileNotFoundError(
            f"{name_or_path!r} is neither a local directory nor an "
            "org/name HF repo id"
        )
    cached = _cache_snapshot(name_or_path, cache_dir)
    # a usable snapshot needs actual weights — config.json alone is a
    # torn download, and serving it would mean random-init params
    if cached is not None and any(
        f.endswith(".safetensors") for f in os.listdir(cached)
    ):
        logger.info("resolved %s from local HF cache: %s", name_or_path, cached)
        return cached
    if os.environ.get("HF_HUB_OFFLINE"):
        raise FileNotFoundError(
            f"{name_or_path!r} not in the local HF cache and HF_HUB_OFFLINE "
            "is set — pre-seed the cache or pass a local path"
        )
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:  # pragma: no cover - baked into this image
        raise FileNotFoundError(
            f"{name_or_path!r} needs huggingface_hub to download"
        ) from e
    logger.info("downloading %s from the HF hub", name_or_path)
    return snapshot_download(
        name_or_path, allow_patterns=_NEEDED, cache_dir=cache_dir
    )
