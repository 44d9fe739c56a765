"""Persistent grammar-FSM compile cache: compiled token-level FSMs keyed
by (spec hash, tokenizer fingerprint), stored as ``.npz`` files on disk.

The port's own copy of ``tpuserve/runtime/grammar/cache.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

A production-vocab (151k) inline compile walks every token's text through
cloned char machines — seconds of admission latency per new grammar.  The
compiled artefact depends only on the grammar text and the vocabulary's
decoded token texts, so it is safely shareable across processes and pod
restarts: the deploy manifests point ``TPUSERVE_FSM_CACHE_DIR`` at the
model PVC (next to the persistent XLA compile cache,
provision/manifests.py), and a local engine defaults to
``<checkpoint_dir>/fsm_cache``.  A cache hit skips BOTH the determinizing
walk and the token-text-table build (the two dominant fixed costs).

Writes are atomic (tmp file + rename) so concurrent engines on one PVC
cannot serve each other torn files; unreadable/corrupt entries are
treated as misses, never errors — the cache degrades to inline compile,
exactly like every other fallback in runtime/grammar/.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile

import numpy as np

from tpuserve_torch.runtime.grammar.fsm import TokenFSM

logger = logging.getLogger("tpuserve_torch.grammar.cache")

# bump when the TokenFSM on-disk field set changes — old entries then
# miss instead of deserializing into the wrong shape
_FORMAT = 1


def resolve_cache_dir(checkpoint_dir: str | None = None) -> str | None:
    """Where compiled FSMs persist: ``TPUSERVE_FSM_CACHE_DIR`` (the
    deploy manifests point it at the model PVC) wins; otherwise a
    ``fsm_cache/`` dir beside the checkpoint; None (random-init engines,
    tests) disables persistence entirely."""
    env = os.environ.get("TPUSERVE_FSM_CACHE_DIR")
    if env:
        return env
    if checkpoint_dir:
        return os.path.join(checkpoint_dir, "fsm_cache")
    return None


def tokenizer_fingerprint(tokenizer, vocab_size: int, eos_ids) -> str:
    """Hash of everything a compiled FSM depends on tokenizer-side.

    The FSM is a function of every token's decoded text; hashing the full
    vocab mapping (HF ``get_vocab`` when available) captures that without
    decoding 151k ids.  Tokenizers without a vocab dump (the byte
    fallback) hash their class + size — their decode is structural."""
    h = hashlib.sha256()
    h.update(f"fmt{_FORMAT}:{type(tokenizer).__name__}:{vocab_size}:"
             f"{sorted(set(eos_ids))}".encode())
    inner = getattr(tokenizer, "_tok", None)
    get_vocab = getattr(inner, "get_vocab", None)
    if get_vocab is not None:
        try:
            for tok, tid in sorted(get_vocab().items(),
                                   key=lambda kv: kv[1]):
                h.update(f"{tid}:{tok}\n".encode())
        except Exception:
            pass
    return h.hexdigest()[:32]


def _entry_path(cache_dir: str, mode: str, schema, tok_fp: str) -> str:
    spec = hashlib.sha256(
        f"{mode}\x00{schema or ''}".encode()).hexdigest()[:32]
    return os.path.join(cache_dir, f"fsm-{spec}-{tok_fp}.npz")


def load_fsm(cache_dir: str, mode: str, schema,
             tok_fp: str) -> TokenFSM | None:
    """Cached TokenFSM for (spec, tokenizer), or None on miss/corruption
    (corruption logs and misses — never raises into admission)."""
    path = _entry_path(cache_dir, mode, schema, tok_fp)
    try:
        with np.load(path) as z:
            return TokenFSM(
                masks=z["masks"], tok_class=z["tok_class"],
                class_next=z["class_next"], can_finish=z["can_finish"],
                complete=z["complete"], vocab_size=int(z["vocab_size"]),
                start=int(z["start"]))
    except FileNotFoundError:
        return None
    except Exception as e:          # torn/stale entry: miss, not error
        logger.warning("unreadable FSM cache entry %s (%s); recompiling",
                       path, e)
        return None


def save_fsm(cache_dir: str, mode: str, schema, tok_fp: str,
             fsm: TokenFSM) -> None:
    """Persist a compiled FSM atomically (tmp + rename, so a concurrent
    reader on the shared PVC never sees a half-written file).  IO errors
    log and drop — persistence is an optimisation, never a failure."""
    path = _entry_path(cache_dir, mode, schema, tok_fp)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(
                    f, masks=fsm.masks, tok_class=fsm.tok_class,
                    class_next=fsm.class_next, can_finish=fsm.can_finish,
                    complete=fsm.complete,
                    vocab_size=np.int64(fsm.vocab_size),
                    start=np.int64(fsm.start))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        logger.warning("could not persist FSM cache entry %s (%s)", path, e)
