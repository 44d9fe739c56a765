"""HF checkpoint downloader, the ``--download-model`` analog: the port's
own copy of ``tpuserve/models/download.py``.

Snapshots a Hugging Face repository's weights, configs and tokenizer files
into ``<out_dir>/<model>``, which ``--checkpoint-dir`` then loads.  It
needs ``huggingface_hub`` and network access; a machine without either
pre-populates the directory instead.

    python -m tpuserve_torch.models.download --model Qwen/Qwen3-0.6B --out /models
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger("tpuserve_torch.download")

_WEIGHT_PATTERNS = ["*.safetensors", "*.json", "*.txt", "tokenizer*",
                    "*.model", "*.jinja"]


def download_model(model: str, out_dir: str,
                   token: str | None = None) -> str:
    """Snapshot the HF repo into ``<out_dir>/<model>``; idempotent (a
    complete snapshot already there, a config and some safetensors, is
    reused)."""
    target = os.path.join(out_dir, model)
    cfg = os.path.join(target, "config.json")
    if os.path.isfile(cfg) and any(
            f.endswith(".safetensors") for f in os.listdir(target)):
        logger.info("checkpoint already present at %s", target)
        return target
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is required to download models; "
            "pre-populate the checkpoint dir instead") from e
    os.makedirs(target, exist_ok=True)
    snapshot_download(repo_id=model, local_dir=target,
                      allow_patterns=_WEIGHT_PATTERNS,
                      token=token or os.environ.get("HF_TOKEN") or None)
    logger.info("downloaded %s -> %s", model, target)
    return target


def main(argv=None):
    ap = argparse.ArgumentParser(description="Download HF model weights")
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", default="/models")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    download_model(args.model, args.out)


if __name__ == "__main__":
    main()
