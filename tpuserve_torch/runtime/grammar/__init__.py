"""Grammar-FSM guided decoding: compiled token-level constraints.

The port's own copy of ``tpuserve/runtime/grammar/__init__.py`` (pure Python and
numpy; the port imports nothing of the JAX package): the same budgets,
environment variables and packed layout, so tables, cache entries and
settings carry over between the two packages.

This package turns a guided spec (``response_format`` json / json_schema,
``guided_regex``, ``guided_choice``) into a **token-level finite-state
machine** over the serving vocabulary: per-state packed allowed-token
bitmasks plus a class-compressed transition table (runtime/grammar/fsm.py).
The engine ships the masks and transitions to the device once per grammar
and the fused decode window masks logits BEFORE top-k/top-p/sampling and
advances the FSM state on device between scan iterations
(models/transformer.py decode_multi), so guided requests ride
``multi_step`` windows instead of pinning to S=1 — and the sampled
distribution is the renormalised truth over the legal token set
(distribution-correct by construction), replacing the top-K
candidate-substitution fallback whose distortion was unbounded.

The compiler (runtime/grammar/compile.py) determinizes the EXISTING
char-level acceptors (runtime/guided.py, guided_regex.py — whose Thompson
NFAs it reuses — and guided_choice.py) by walking every vocabulary
token's decoded text through cloned machines, deduplicating on their
``state_key()``.  Grammars that exceed the state/walk budgets (deep
schema numeric-bound prefixes, huge vocabularies without a cache) fail
compilation loudly and the engine falls back to the per-step
candidate-substitution path, whose distortion is now statistically
bounded by tests (tests/test_guided_fsm.py).
"""

from tpuserve_torch.runtime.grammar.cache import (load_fsm, resolve_cache_dir,
                                            save_fsm,
                                            tokenizer_fingerprint)
from tpuserve_torch.runtime.grammar.compile import (FsmCompileError,
                                              compile_token_fsm,
                                              fsm_for_spec,
                                              token_text_table)
from tpuserve_torch.runtime.grammar.fsm import TokenFSM, pack_masks, unpack_masks

__all__ = [
    "TokenFSM", "pack_masks", "unpack_masks",
    "FsmCompileError", "compile_token_fsm", "fsm_for_spec",
    "token_text_table",
    "load_fsm", "save_fsm", "resolve_cache_dir", "tokenizer_fingerprint",
]
