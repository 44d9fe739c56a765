"""Parameters of the port's transformer.

The tree has the JAX package's layout — ``{"embed": {"weight"}, "layers":
[{"q_proj": {"kernel", ...}, ...}], "final_norm": {...}[, "lm_head"]}`` —
with linear kernels stored ``(in, out)``, so the two packages' trees map
leaf for leaf.  Two ways to fill it:

- :func:`params_from_numpy` converts the JAX package's tree given as numpy
  arrays (``jax.tree.map(np.asarray, params)``);
- :func:`init_params` reproduces ``tpuserve.models.weights.init_params``
  draw for draw (same ``np.random.default_rng(seed)``, same order, same
  float32-then-cast rounding), so a run on the card gets the JAX engine's
  exact random weights without importing JAX; :func:`init_params_device`
  draws the same tree on the card (other numbers), for models whose host
  draws would take minutes.  MoE layers carry the JAX layout: ``router``,
  an optional float32 ``router_bias``, ``experts`` stacked (E, n_in,
  n_out) and DeepSeek's ``shared`` experts; MLA layers (DeepSeek) carry
  ``kv_a_proj``, ``kv_a_norm``, ``kv_b_proj`` and either ``q_proj`` or
  ``q_a_proj`` / ``q_a_norm`` / ``q_b_proj``.

- :func:`load_hf_checkpoint` reads a local HuggingFace safetensors
  directory (one file or index-sharded) with the port's own parser
  (:func:`read_safetensors`) and maps its names as the JAX loader does,
  leaf by leaf onto the device.

Two transforms of a tree, the JAX package's: :func:`quantize_params_int8`
(weight-only int8, which also runs a layer at a time as a tree is made,
:func:`quantize_layer_int8`), and PEFT LoRA adapters, merged into the
weights (:func:`apply_lora`) or stacked for per-request selection
(:func:`load_lora_stack`), read by :func:`read_lora_adapter` without the
``safetensors`` package.
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
import re
import struct

import numpy as np
import torch

from tpuserve_torch.models.config import ModelConfig

logger = logging.getLogger("tpuserve_torch.weights")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    try:
        return DTYPES[cfg.dtype]
    except KeyError:
        raise NotImplementedError(f"model dtype {cfg.dtype!r} not supported "
                                  f"(one of {sorted(DTYPES)})") from None


def params_from_numpy(tree, cfg: ModelConfig, device) -> dict:
    """The JAX package's parameter tree, as numpy arrays, on ``device`` in
    the model's dtype; an MoE ``router_bias`` and the float32 ``scale`` of
    an int8 kernel or embedding stay float32 and int8 leaves int8, as
    there."""
    dtype = param_dtype(cfg)

    def conv(x, leaf_dtype=dtype):
        if isinstance(x, dict):
            quantized = "scale" in x and ("kernel" in x or "weight" in x)
            return {k: conv(v, torch.float32 if k == "router_bias"
                            or (quantized and k == "scale") else leaf_dtype)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, leaf_dtype) for v in x]
        arr = np.array(x)                      # a writable host copy
        if arr.dtype == np.int8:
            return torch.from_numpy(arr).to(device)
        if arr.dtype.name == "bfloat16":       # ml_dtypes: go through float32
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(leaf_dtype).to(device)
    return conv(tree)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", layer_fn=None) -> dict:
    """Random-normal parameters, equal to the JAX package's
    ``init_params(cfg, seed)`` value for value.  ``layer_fn``: applied to
    each layer's dict as soon as it is made (``quantize_layer_int8``, so a
    quantized model never exists whole in the model's dtype)."""
    rng = np.random.default_rng(seed)
    dtype = param_dtype(cfg)

    def normal(shape, scale):
        # draw and scale in numpy, cast on the host: the rounding the
        # test pins (float32 draws, the JAX init's arithmetic)
        return torch.from_numpy(scale(rng.standard_normal(shape, dtype=np.float32))).to(
            dtype).to(device)
    return _init_tree(cfg, normal, dtype, device, layer_fn)


def init_params_device(cfg: ModelConfig, seed: int = 0, device="cuda",
                       layer_fn=None) -> dict:
    """Random-normal parameters with :func:`init_params`' tree, shapes,
    dtypes and scales, drawn on ``device`` by a seeded ``torch.Generator``:
    seconds for tens of billions of values where host draws take minutes,
    but not the JAX init's numbers.  ``layer_fn`` as :func:`init_params`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = param_dtype(cfg)

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return scale(x).to(dtype)
    return _init_tree(cfg, normal, dtype, device, layer_fn)


def _init_tree(cfg: ModelConfig, normal, dtype, device, layer_fn=None) -> dict:
    """The JAX init's tree, in its draw order: ``normal(shape, scale)``
    draws a float32 standard normal of ``shape``, applies ``scale`` and
    returns it in the model's dtype on ``device``; ``layer_fn`` maps each
    layer once made."""
    def dense(n_in, n_out, bias):
        p = {"kernel": normal((n_in, n_out), lambda x: x / np.sqrt(n_in))}
        if bias:
            p["bias"] = torch.zeros((n_out,), dtype=dtype, device=device)
        return p

    # Gemma-style norms store (weight - 1): init so the effective gain is 1
    norm_init = 1.0 - cfg.norm_weight_offset

    def norm(n):
        p = {"scale": torch.full((n,), norm_init, dtype=dtype, device=device)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros((n,), dtype=dtype, device=device)
        return p

    h, d = cfg.hidden_size, cfg.head_dim
    layers = []
    for li in range(cfg.num_layers):
        if cfg.is_mla:
            # DeepSeek MLA: the compressed-KV latent and shared roped key,
            # the per-head up-projections packed in kv_b_proj, a low-rank or
            # direct q projection
            lp = {
                "attn_norm": norm(h),
                "kv_a_proj": dense(h, cfg.mla_latent_dim, cfg.attention_bias),
                "kv_a_norm": norm(cfg.mla_kv_lora_rank),
                "kv_b_proj": dense(cfg.mla_kv_lora_rank, cfg.num_heads * (
                    cfg.mla_qk_nope_head_dim + cfg.mla_v_head_dim), False),
                "o_proj": dense(cfg.num_heads * cfg.mla_v_head_dim, h, cfg.attention_bias),
                "mlp_norm": norm(h),
            }
            if cfg.mla_q_lora_rank:
                lp["q_a_proj"] = dense(h, cfg.mla_q_lora_rank, cfg.attention_bias)
                lp["q_a_norm"] = norm(cfg.mla_q_lora_rank)
                lp["q_b_proj"] = dense(cfg.mla_q_lora_rank, cfg.q_size, False)
            else:
                lp["q_proj"] = dense(h, cfg.q_size, False)
        else:
            lp = {
                "attn_norm": norm(h),
                "q_proj": dense(h, cfg.q_size, cfg.attention_bias),
                "k_proj": dense(h, cfg.kv_size, cfg.attention_bias),
                "v_proj": dense(h, cfg.kv_size, cfg.attention_bias),
                "o_proj": dense(cfg.q_size, h,
                                cfg.attention_bias and cfg.pos == "learned"),
                "mlp_norm": norm(h),
            }
        if cfg.qk_norm:
            lp["q_norm"] = {"scale": torch.full((d,), norm_init, dtype=dtype,
                                                device=device)}
            lp["k_norm"] = {"scale": torch.full((d,), norm_init, dtype=dtype,
                                                device=device)}
        if cfg.sandwich_norms:
            lp["post_attn_norm"] = norm(h)
            lp["post_mlp_norm"] = norm(h)
        if cfg.num_experts and not cfg.moe_layer_is_dense(li):
            ei, E = cfg.expert_intermediate_size, cfg.num_experts

            def experts(n_in, n_out):
                # stacked (E, n_in, n_out), the JAX layout
                return {"kernel": normal((E, n_in, n_out), lambda x: x / np.sqrt(n_in))}
            lp["router"] = dense(h, E, False)
            if cfg.moe_router_bias:
                # e_score_correction_bias: selection-only, stays float32
                lp["router_bias"] = {"bias": torch.zeros((E,), dtype=torch.float32,
                                                         device=device)}
            lp["experts"] = {"gate_proj": experts(h, ei), "up_proj": experts(h, ei),
                             "down_proj": experts(ei, h)}
            if cfg.moe_shared_experts:
                si = ei * cfg.moe_shared_experts
                lp["shared"] = {"gate_proj": dense(h, si, False),
                                "up_proj": dense(h, si, False),
                                "down_proj": dense(si, h, False)}
        elif cfg.mlp_style == "gated":
            lp["gate_proj"] = dense(h, cfg.intermediate_size, cfg.mlp_bias)
            lp["up_proj"] = dense(h, cfg.intermediate_size, cfg.mlp_bias)
            lp["down_proj"] = dense(cfg.intermediate_size, h, cfg.mlp_bias)
        else:
            lp["fc1"] = dense(h, cfg.intermediate_size, cfg.mlp_bias)
            lp["fc2"] = dense(cfg.intermediate_size, h, cfg.mlp_bias)
        layers.append(layer_fn(lp) if layer_fn else lp)

    params = {
        "embed": {"weight": normal((cfg.vocab_size, h), lambda x: x * 0.02)},
        "layers": layers,
        "final_norm": norm(h),
    }
    if cfg.pos == "learned":
        params["pos_embed"] = {"weight": normal(
            (cfg.max_position_embeddings + cfg.learned_pos_offset, h), lambda x: x * 0.02)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size, False)
    return params


def map_leaves(fn, params):
    """``params`` with ``fn`` applied to each leaf (the tree's shape kept)."""
    if isinstance(params, dict):
        return {k: map_leaves(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(map_leaves(fn, v) for v in params)
    return None if params is None else fn(params)


def to_device(params, device):
    """A host tree on ``device``, leaf by leaf (asynchronous from pinned
    memory)."""
    return map_leaves(lambda a: a.to(device, non_blocking=True), params)


def param_nbytes(params) -> int:
    """Total bytes of a parameter tree's tensors."""
    if isinstance(params, dict):
        return sum(param_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_nbytes(v) for v in params)
    return params.numel() * params.element_size()


# --------------------------------------------------------------------------
# HF checkpoint loading
# --------------------------------------------------------------------------

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}


class SafetensorsDir:
    """Every tensor of a directory's ``*.safetensors`` files, read through
    ``mmap`` without the ``safetensors`` package.

    A file is an 8-byte little-endian header length, a JSON header (name ->
    dtype, shape, ``data_offsets`` counted from the end of the header; the
    ``__metadata__`` entry is skipped), then the data.  ``self[name]`` is a
    tensor that shares the mapped file's memory: copy it before the
    ``with`` block ends, which closes the mappings.  A name found in two
    files is an error."""

    def __init__(self, ckpt_dir: str, files: list[str] | None = None):
        # ``files``: these files only (a PEFT adapter's one file)
        self.files = files or sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
        if not self.files:
            raise FileNotFoundError(f"no .safetensors files in {ckpt_dir}")
        self._maps: list[mmap.mmap] = []
        self._index: dict[str, tuple] = {}     # name -> (map, dtype, shape, start, end)
        try:
            for path in self.files:
                self._open(path)
        except BaseException:
            self.close()
            raise

    def _open(self, path: str) -> None:
        with open(path, "rb") as f:
            # a private copy-on-write map: writable, so torch.frombuffer
            # shares it without a warning; nothing writes to it
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._maps.append(mm)
        if len(mm) < 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", mm[:8])
        if 8 + n > len(mm):
            raise ValueError(f"{path}: header length {n} past the end of the file")
        header = json.loads(mm[8:8 + n])
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if name in self._index:
                raise ValueError(f"tensor {name!r} is in more than one file "
                                 f"of the checkpoint (again in {path})")
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise NotImplementedError(f"{path}: {name} has safetensors dtype "
                                          f"{info['dtype']}, not one of {sorted(_ST_DTYPES)}")
            shape = tuple(info["shape"])
            start, end = info["data_offsets"]
            itemsize = torch.empty((), dtype=dtype).element_size()
            if end - start != int(np.prod(shape, dtype=np.int64)) * itemsize \
                    or base + end > len(mm):
                raise ValueError(f"{path}: {name}'s data_offsets {start}-{end} do not "
                                 f"hold a {info['dtype']} tensor of shape {list(shape)}")
            self._index[name] = (mm, dtype, shape, base + start, base + end)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __iter__(self):
        return iter(self._index)

    def __getitem__(self, name: str) -> torch.Tensor:
        mm, dtype, shape, start, end = self._index[name]
        if start == end:
            return torch.empty(shape, dtype=dtype)
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        return torch.frombuffer(mm, dtype=dtype, count=count, offset=start).view(shape)

    def close(self) -> None:
        for mm in self._maps:
            try:
                mm.close()
            except BufferError:
                # a tensor still shares it (an error unwinding past a view):
                # the map closes when that tensor is freed
                pass
        self._maps.clear()
        self._index.clear()

    def __enter__(self) -> "SafetensorsDir":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_safetensors(ckpt_dir: str) -> SafetensorsDir:
    """All tensors of a single-file or index-sharded safetensors checkpoint
    (every ``*.safetensors`` file in the directory, as the JAX loader
    reads them); use as a context manager."""
    return SafetensorsDir(ckpt_dir)


def load_hf_checkpoint(cfg: ModelConfig, ckpt_dir: str, device="cuda",
                       layer_fn=None, shard=None, layers=None, head: bool = True) -> dict:
    """An HF checkpoint directory as the transformer's parameter tree, the
    JAX loader's names and layouts (``tpuserve/models/weights.py``):
    linear kernels ``(out, in)`` -> ``(in, out)``, Phi-3's fused
    ``qkv_proj`` and ``gate_up_proj`` split, Qwen3's q/k norms, Gemma2's
    sandwich norms, no ``lm_head`` with tied embeddings, OPT's learned
    positions and layernorm biases, DeepSeek's MLA projections with their
    interleaved rope channels permuted once (:func:`_mla_deinterleave`).
    Each leaf is copied to ``device`` in the model's dtype before the next
    is read, so the host never holds the model twice; ``layer_fn`` maps
    each layer once loaded (as :func:`init_params`).  ``shard``: a rank's
    slicer (``parallel.sharding.RankSlicer``), which cuts each leaf to the
    rank's block before it is read from the mapped file (and loads only the
    rank's experts), so no rank reads the whole model.  ``layers``: the
    layer indices to read (a pipeline stage's; all when None); ``head``:
    whether to read the top-level leaves (embeddings, final norm, head) —
    without them the tree is ``{"layers": [...]}``."""
    dtype = param_dtype(cfg)
    device = torch.device(device)
    layers = range(cfg.num_layers) if layers is None else layers
    with read_safetensors(ckpt_dir) as raw:
        if cfg.pos == "learned":
            return _load_opt(cfg, raw, dtype, device, layer_fn, shard, layers, head)
        return _load_llama_family(cfg, raw, dtype, device, layer_fn, shard, layers, head)


def _put(w: torch.Tensor, dtype, device, t: bool = False, path: str | None = None,
         shard=None) -> torch.Tensor:
    """One leaf on the device in ``dtype`` (transposed from HF's (out, in)
    to (in, out) when ``t``), never a view of the mapped file; with
    ``shard``, only the rank's block of the leaf at ``path`` is read."""
    if shard is not None and path is not None:
        w = shard(path, w.T if t else w)
        return w.to(device=device, dtype=dtype, copy=True).contiguous()
    w = w.to(device=device, dtype=dtype, copy=True)
    return w.T.contiguous() if t else w


def _mla_deinterleave(p: dict, cfg: ModelConfig, heads: int, head_width: int) -> dict:
    """Bake DeepSeek's interleaved rope channel order out of a projection,
    as the JAX loader does: HF applies rope to these checkpoints with GPT-J
    pairing, a permutation of each head's last ``mla_qk_rope_head_dim``
    output channels, so permuting the kernel's columns once makes the
    split-half rope (``ops/rope.py``) exact.  The output is ``heads`` x
    ``head_width`` columns."""
    if not cfg.mla_rope_interleave:
        return p
    d = cfg.mla_qk_rope_head_dim
    perm = np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
    idx = np.arange(heads * head_width)
    for hh in range(heads):
        lo = hh * head_width + head_width - d
        idx[lo:lo + d] = lo + perm
    idx = torch.from_numpy(idx).to(p["kernel"].device)
    out = {"kernel": p["kernel"][:, idx].contiguous()}
    if "bias" in p:
        out["bias"] = p["bias"][idx].contiguous()
    return out


def _load_llama_family(cfg: ModelConfig, raw: SafetensorsDir, dtype, device,
                       layer_fn=None, shard=None, held=None, head: bool = True) -> dict:
    def dense(name, bias_name=None, key=None):
        # ``key``: the leaf's place in the tree (``layers.<key>`` or a
        # top-level name), which picks its slice under ``shard``
        path = key if key is None or "." in key else f"layers.{key}"
        p = {"kernel": _put(raw[name], dtype, device, t=True,
                            path=path and path + ".kernel", shard=shard)}
        if bias_name and bias_name in raw:
            p["bias"] = _put(raw[bias_name], dtype, device, path=path and path + ".bias",
                             shard=shard)
        return p

    def norm_scale(name):
        return {"scale": _put(raw[name], dtype, device)}

    def split(name, sizes, keys):
        # a fused (out, in) projection: its row blocks, each as (in, out)
        return [{"kernel": _put(w, dtype, device, t=True, path=f"layers.{k}.kernel",
                                shard=shard)}
                for w, k in zip(torch.split(raw[name], sizes, dim=0), keys)]

    layers = []
    for i in held:
        pre = f"model.layers.{i}."
        lp = {"attn_norm": norm_scale(pre + "input_layernorm.weight"),
              "o_proj": dense(pre + "self_attn.o_proj.weight", key="o_proj")}
        if cfg.sandwich_norms:
            # Gemma2: post_attention_layernorm wraps the attention output;
            # the MLP pre-norm is pre_feedforward_layernorm
            lp["post_attn_norm"] = norm_scale(pre + "post_attention_layernorm.weight")
            lp["mlp_norm"] = norm_scale(pre + "pre_feedforward_layernorm.weight")
            lp["post_mlp_norm"] = norm_scale(pre + "post_feedforward_layernorm.weight")
        else:
            lp["mlp_norm"] = norm_scale(pre + "post_attention_layernorm.weight")
        if cfg.is_mla:                                          # DeepSeek MLA
            lp["kv_a_proj"] = _mla_deinterleave(
                dense(pre + "self_attn.kv_a_proj_with_mqa.weight",
                      pre + "self_attn.kv_a_proj_with_mqa.bias"),
                cfg, heads=1, head_width=cfg.mla_latent_dim)
            lp["kv_a_norm"] = norm_scale(pre + "self_attn.kv_a_layernorm.weight")
            lp["kv_b_proj"] = dense(pre + "self_attn.kv_b_proj.weight", key="kv_b_proj")
            if cfg.mla_q_lora_rank:
                lp["q_a_proj"] = dense(pre + "self_attn.q_a_proj.weight",
                                       pre + "self_attn.q_a_proj.bias")
                lp["q_a_norm"] = norm_scale(pre + "self_attn.q_a_layernorm.weight")
                lp["q_b_proj"] = _mla_deinterleave(
                    dense(pre + "self_attn.q_b_proj.weight", key="q_b_proj"), cfg,
                    heads=cfg.num_heads // _tp(shard), head_width=cfg.head_dim)
            else:
                lp["q_proj"] = _mla_deinterleave(
                    dense(pre + "self_attn.q_proj.weight", key="q_proj"), cfg,
                    heads=cfg.num_heads // _tp(shard), head_width=cfg.head_dim)
        elif pre + "self_attn.qkv_proj.weight" in raw:          # Phi-3 fused qkv
            lp["q_proj"], lp["k_proj"], lp["v_proj"] = split(
                pre + "self_attn.qkv_proj.weight", [cfg.q_size, cfg.kv_size, cfg.kv_size],
                ("q_proj", "k_proj", "v_proj"))
        else:
            for proj in ("q", "k", "v"):
                lp[f"{proj}_proj"] = dense(pre + f"self_attn.{proj}_proj.weight",
                                           pre + f"self_attn.{proj}_proj.bias",
                                           key=f"{proj}_proj")
        if cfg.qk_norm:
            lp["q_norm"] = norm_scale(pre + "self_attn.q_norm.weight")
            lp["k_norm"] = norm_scale(pre + "self_attn.k_norm.weight")
        if cfg.num_experts and not cfg.moe_layer_is_dense(i):   # Qwen3 / DeepSeek MoE
            lp.update(_load_moe_layer(cfg, raw, pre, dtype, device, shard))
        elif pre + "mlp.gate_up_proj.weight" in raw:            # Phi-3 fused mlp
            lp["gate_proj"], lp["up_proj"] = split(
                pre + "mlp.gate_up_proj.weight", [cfg.intermediate_size] * 2,
                ("gate_proj", "up_proj"))
            lp["down_proj"] = dense(pre + "mlp.down_proj.weight", key="down_proj")
        else:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                lp[proj] = dense(pre + f"mlp.{proj}.weight", key=proj)
        layers.append(layer_fn(lp) if layer_fn else lp)
    if not head:
        return {"layers": layers}
    params = {"embed": {"weight": _put(raw["model.embed_tokens.weight"], dtype, device,
                                       path="embed.weight", shard=shard)},
              "layers": layers,
              "final_norm": norm_scale("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense("lm_head.weight", key="lm_head.")
    return params


def _tp(shard) -> int:
    """The tp degree of a rank's slicer (1 without one)."""
    return 1 if shard is None else shard.tp


def _load_moe_layer(cfg: ModelConfig, raw: SafetensorsDir, pre: str, dtype, device,
                    shard=None) -> dict:
    """One MoE layer's router (and float32 selection bias), its experts
    stacked (E, n_in, n_out) on the device one expert at a time (no host
    copy of a whole stack; under ``shard`` the rank's E / ep only), and its
    shared experts."""
    E, h, ei = cfg.num_experts, cfg.hidden_size, cfg.expert_intermediate_size
    held = range(E) if shard is None else shard.experts(E)
    lp = {"router": {"kernel": _put(raw[pre + "mlp.gate.weight"], dtype, device, t=True)}}
    if cfg.moe_router_bias:
        lp["router_bias"] = {"bias": _put(raw[pre + "mlp.gate.e_score_correction_bias"],
                                          torch.float32, device)}
    experts = {}
    for proj, shape in (("gate_proj", (h, ei)), ("up_proj", (h, ei)), ("down_proj", (ei, h))):
        w = torch.empty((len(held), *shape), dtype=dtype, device=device)
        for i, e in enumerate(held):
            w[i] = _put(raw[pre + f"mlp.experts.{e}.{proj}.weight"], dtype, device, t=True)
        experts[proj] = {"kernel": w}
    lp["experts"] = experts
    if cfg.moe_shared_experts:
        lp["shared"] = {proj: {"kernel": _put(raw[pre + f"mlp.shared_experts.{proj}.weight"],
                                              dtype, device, t=True,
                                              path=f"layers.shared.{proj}.kernel",
                                              shard=shard)}
                        for proj in ("gate_proj", "up_proj", "down_proj")}
    return lp


def _load_opt(cfg: ModelConfig, raw: SafetensorsDir, dtype, device, layer_fn=None,
              shard=None, held=None, head: bool = True) -> dict:
    def get(name):
        # OPT checkpoints may or may not carry the "model." prefix
        for cand in (name, "model." + name):
            if cand in raw:
                return raw[cand]
        raise KeyError(name)

    def dense(name, key):
        path = f"layers.{key}"
        p = {"kernel": _put(get(name + ".weight"), dtype, device, t=True,
                            path=path + ".kernel", shard=shard)}
        try:
            p["bias"] = _put(get(name + ".bias"), dtype, device, path=path + ".bias",
                             shard=shard)
        except KeyError:
            pass
        return p

    def norm(name):
        return {"scale": _put(get(name + ".weight"), dtype, device),
                "bias": _put(get(name + ".bias"), dtype, device)}

    layers = []
    for i in held:
        pre = f"decoder.layers.{i}."
        lp = {
            "attn_norm": norm(pre + "self_attn_layer_norm"),
            "q_proj": dense(pre + "self_attn.q_proj", "q_proj"),
            "k_proj": dense(pre + "self_attn.k_proj", "k_proj"),
            "v_proj": dense(pre + "self_attn.v_proj", "v_proj"),
            "o_proj": dense(pre + "self_attn.out_proj", "o_proj"),
            "mlp_norm": norm(pre + "final_layer_norm"),
            "fc1": dense(pre + "fc1", "fc1"),
            "fc2": dense(pre + "fc2", "fc2"),
        }
        layers.append(layer_fn(lp) if layer_fn else lp)
    if not head:
        return {"layers": layers}
    return {"embed": {"weight": _put(get("decoder.embed_tokens.weight"), dtype, device,
                                     path="embed.weight", shard=shard)},
            "pos_embed": {"weight": _put(get("decoder.embed_positions.weight"),
                                         dtype, device)},
            "layers": layers,
            "final_norm": norm("decoder.final_layer_norm")}


def load_or_init(cfg: ModelConfig, ckpt_dir: str | None, seed: int = 0,
                 device="cuda", layer_fn=None, shard=None) -> dict:
    """The checkpoint in ``ckpt_dir`` when it holds ``*.safetensors``, else
    random init from ``seed`` (the JAX package's rule), which is logged;
    ``layer_fn`` as :func:`init_params`.  ``shard`` (a rank's
    ``parallel.sharding.RankSlicer``): the loader reads only the rank's
    slices; the init draws each layer whole, in the JAX order, and keeps
    the rank's slice before the next layer (after ``layer_fn``, so int8
    scales are the whole kernel's, as the JAX engine quantizes, then
    shards).  A pipeline stage's slicer keeps its stage's layers and, on
    stage 0, the head; from a checkpoint the stage reads only those."""
    if ckpt_dir and glob.glob(os.path.join(ckpt_dir, "*.safetensors")):
        logger.info("loading checkpoint %s", ckpt_dir)
        if shard is not None and shard.pp > 1:
            return load_hf_checkpoint(cfg, ckpt_dir, device, layer_fn, layers=shard.held,
                                      head=shard.holds_head)
        if shard is not None and layer_fn is not None:
            # a row-parallel int8 scale is over the kernel's every row: load
            # each layer whole, quantize, then keep the rank's slice
            return load_hf_checkpoint(cfg, ckpt_dir, device,
                                      lambda lp: shard.layer(layer_fn(lp)),
                                      shard=shard.top_level())
        return load_hf_checkpoint(cfg, ckpt_dir, device, layer_fn, shard)
    logger.info("no *.safetensors in %s: random init of %s from seed %d",
                ckpt_dir, cfg.name, seed)
    if shard is None:
        return init_params(cfg, seed, device, layer_fn)
    return shard.tree(init_params(
        cfg, seed, device, lambda lp: shard.layer(layer_fn(lp) if layer_fn else lp)),
        skip_layers=True)


# --------------------------------------------------------------------------
# Weight-only int8 quantization
# --------------------------------------------------------------------------

def _quantize_channelwise(w: torch.Tensor, keep: tuple[int, ...]):
    """w -> (int8 weights, float32 scales over the ``keep`` axes), the JAX
    ``_quantize_channelwise``: symmetric, scale = max|w| / 127 over the
    other axes (1 where that is 0), q = rint(w / scale) clipped to +-127,
    all in float32 (``torch.round`` rounds half to even, as ``np.rint``).
    Runs on ``w``'s device."""
    w32 = w.float()
    reduce = tuple(i for i in range(w32.dim()) if i not in keep)
    amax = w32.abs().amax(dim=reduce, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    kept = tuple(w32.shape[i] for i in sorted(keep))
    return q, scale.reshape(kept)


def _quantize_linear(p: dict) -> dict:
    """A linear ``{"kernel", ["bias"]}`` with an int8 kernel and its (out,)
    scale (unchanged when already int8); the bias stays as it was."""
    if p["kernel"].dtype == torch.int8:
        return p
    q, scale = _quantize_channelwise(p["kernel"], (1,))
    out = {"kernel": q, "scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_layer_int8(lp: dict) -> dict:
    """One layer of :func:`quantize_params_int8`: every linear kernel int8
    with an (out,) scale; stacked experts (E, in, out) with (E, out)
    scales; DeepSeek's shared experts as linears; norms and the float32
    ``router_bias`` untouched.  Each float kernel is dropped once its int8
    copy exists."""
    out = {}
    for name, p in lp.items():
        if name == "experts":
            out[name] = {}
            for proj, ep in p.items():
                if ep["kernel"].dtype == torch.int8:
                    out[name][proj] = ep
                else:
                    q, scale = _quantize_channelwise(ep["kernel"], (0, 2))
                    out[name][proj] = {"kernel": q, "scale": scale}
        elif name == "shared":
            out[name] = {k: _quantize_linear(v) for k, v in p.items()}
        else:
            out[name] = _quantize_linear(p) if "kernel" in p else p
    return out


def quantize_params_int8(params: dict) -> dict:
    """Weight-only int8, the JAX package's ``quantize_params_int8``: every
    linear kernel and the token embedding int8 with float32 scales (the
    embedding's a vocabulary row, serving the gather and, when tied, the
    unembedding); positions and norms stay as they are.  Layers already
    quantized (``layer_fn=quantize_layer_int8`` at load) pass through.
    Returns a new tree and leaves ``params`` as it was."""
    new = {"layers": [quantize_layer_int8(lp) for lp in params["layers"]]}
    embed = params.get("embed")         # a later pipeline stage has none
    if embed is not None and embed["weight"].dtype == torch.int8:
        new["embed"] = embed
    elif embed is not None:
        eq, escale = _quantize_channelwise(embed["weight"], (0,))
        new["embed"] = {"weight": eq, "scale": escale}
    if "lm_head" in params:
        new["lm_head"] = _quantize_linear(params["lm_head"])
    for k in ("pos_embed", "final_norm"):
        if k in params:
            new[k] = params[k]
    return new


def is_quantized(params: dict) -> bool:
    """Whether ``params`` is an int8 tree (its embedding carries a scale;
    a later pipeline stage's, which has none, its first layer's q kernel
    is int8)."""
    if "embed" in params:
        return "scale" in params["embed"]
    lp = params["layers"][0]
    return lp.get("q_proj", {}).get("kernel", torch.empty(0)).dtype == torch.int8


# --------------------------------------------------------------------------
# LoRA adapters: merged at load, or stacked for per-request selection
# --------------------------------------------------------------------------

# HF/PEFT module name -> our layer param key(s), the JAX package's table.  A
# string maps 1:1; a callable receives the ModelConfig and returns [(key,
# out_width), ...] column splits of a fused projection (Phi-3's qkv and
# gate_up, split as the base loader splits them).
_LORA_MODULES = {
    "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj", "self_attn.o_proj": "o_proj",
    "self_attn.out_proj": "o_proj",                       # OPT
    "mlp.gate_proj": "gate_proj", "mlp.up_proj": "up_proj",
    "mlp.down_proj": "down_proj",
    "fc1": "fc1", "fc2": "fc2",                           # OPT
    "self_attn.qkv_proj": lambda cfg: [                   # Phi-3 fused
        ("q_proj", cfg.q_size), ("k_proj", cfg.kv_size),
        ("v_proj", cfg.kv_size)],
    "mlp.gate_up_proj": lambda cfg: [                     # Phi-3 fused
        ("gate_proj", cfg.intermediate_size),
        ("up_proj", cfg.intermediate_size)],
}


def read_lora_adapter(adapter_dir: str) -> tuple[dict, float]:
    """(tensors as float32 numpy arrays, scaling) of a PEFT adapter
    directory: ``adapter_config.json`` (``r``, ``lora_alpha``,
    ``use_rslora``: alpha / sqrt(r) instead of alpha / r) and
    ``adapter_model.safetensors`` (read by :class:`SafetensorsDir`), else
    ``adapter_model.bin`` (``torch.load`` with ``weights_only``)."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    r = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", r))
    if acfg.get("use_rslora"):
        scaling = alpha / max(r, 1) ** 0.5
    else:
        scaling = alpha / max(r, 1)
    st = os.path.join(adapter_dir, "adapter_model.safetensors")
    if os.path.isfile(st):
        with SafetensorsDir(adapter_dir, files=[st]) as raw:
            return {k: raw[k].float().numpy().copy() for k in raw}, scaling
    bin_path = os.path.join(adapter_dir, "adapter_model.bin")
    if os.path.isfile(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}, scaling
    raise FileNotFoundError(f"no adapter_model.safetensors/.bin in {adapter_dir}")


def parse_lora_factors(params: dict, cfg: ModelConfig, adapter_dir: str,
                       label: str = "") -> list:
    """One PEFT adapter checked against the model, as low-rank factors
    [(layer, param key, A (in, r), B (r, w))] in float32 numpy, the scaling
    folded into B and fused HF projections split into this model's
    columns: the JAX ``_parse_lora_factors``, the one parser of
    :func:`apply_lora` and :func:`load_lora_stack`.  Everything is checked
    before it returns, so a caller may mutate ``params`` knowing nothing
    else raises."""
    tag = f" in {label!r}" if label else ""
    raw, scaling = read_lora_adapter(adapter_dir)
    pairs: dict[tuple[int, str], dict] = {}
    for key, tensor in raw.items():
        m = re.search(r"layers\.(\d+)\.([a-z_.0-9]+)\.lora_(A|B)\.weight$", key)
        if m is None:
            raise ValueError(f"unsupported LoRA adapter key {key!r}{tag}")
        li, module, ab = int(m.group(1)), m.group(2), m.group(3)
        if module not in _LORA_MODULES:
            raise ValueError(f"LoRA target module {module!r} not supported "
                             f"(key {key!r}){tag}")
        if li >= cfg.num_layers:
            raise ValueError(f"LoRA key {key!r} targets layer {li} but the "
                             f"model has {cfg.num_layers}{tag}")
        pairs.setdefault((li, module), {})[ab] = np.asarray(tensor, dtype=np.float32)
    if not pairs:
        raise ValueError(f"adapter at {adapter_dir} contained no LoRA pairs")
    factors = []
    for (li, module), ab in sorted(pairs.items()):
        if "A" not in ab or "B" not in ab:
            raise ValueError(f"LoRA pair for layer {li} {module} is missing "
                             f"lora_{'A' if 'A' not in ab else 'B'}{tag}")
        target = _LORA_MODULES[module]
        splits = target(cfg) if callable(target) else [(target, None)]
        # HF shapes: A (r, in), B (out, r) -> ours (in, r) / (r, out)
        A = ab["A"].T
        B = ab["B"].T * scaling
        lp = params["layers"][li]
        col = 0
        for pk, width in splits:
            if pk not in lp or "kernel" not in lp[pk]:
                raise ValueError(f"model has no dense {pk} in layer {li} "
                                 "(MoE expert linears are not LoRA targets)")
            kernel = lp[pk]["kernel"]
            w = kernel.shape[1] if width is None else width
            if kernel.shape[0] != A.shape[0]:
                raise ValueError(
                    f"LoRA delta shape {(A.shape[0], B.shape[1])} does not "
                    f"match weight shape {tuple(kernel.shape)} for layer "
                    f"{li} {pk}{tag}")
            factors.append((li, pk, A, B[:, col:col + w]))
            col += w
        if col != B.shape[1]:
            raise ValueError(
                f"LoRA delta shape {(A.shape[0], B.shape[1])} does not "
                f"match fused projection width {col} for layer {li} "
                f"{module}{tag}")
    return factors


def apply_lora(params: dict, cfg: ModelConfig, adapter_dir: str) -> dict:
    """Merge a PEFT adapter into the dense weights, W += s B A, the JAX
    ``apply_lora``: the sum in float32 (the factors' product computed in
    numpy, as there), cast back to the kernel's dtype.  Refuses int8
    kernels (merge first, quantize after) and checks every target before
    it changes a weight.  Mutates and returns ``params``."""
    factors = parse_lora_factors(params, cfg, adapter_dir)
    for li, pk, _, _ in factors:
        if "scale" in params["layers"][li][pk]:
            raise ValueError(
                "cannot merge LoRA into already-quantized weights; "
                "load the bf16 checkpoint and quantize after")
    for li, pk, A, B in factors:
        lp = params["layers"][li]
        kernel = lp[pk]["kernel"]
        delta = torch.from_numpy(A @ B).to(kernel.device)
        lp[pk]["kernel"] = (kernel.float() + delta).to(kernel.dtype)
    return params


def load_lora_stack(params: dict, cfg: ModelConfig, adapters: dict) -> list:
    """Several PEFT adapters for per-request selection, the JAX
    ``load_lora_stack``: each targeted linear gains a ``lora`` entry of
    stacked factors, A (n, in, r_max) and B (n, r_max, out) in the model's
    dtype, the scaling folded into B and shorter ranks zero-padded; a row
    selects its adapter with one-hot weights (``transformer._lora_delta``),
    a base row with zeros.  Composes with int8 kernels (the delta adds
    after the dequantizing product).  ``adapters``: name -> directory.
    Mutates ``params``; returns the names in index order."""
    names = list(adapters)
    if not names:
        raise ValueError("load_lora_stack needs at least one adapter")
    factors: dict[tuple[int, str], dict[int, tuple]] = {}
    for idx, (name, adapter_dir) in enumerate(adapters.items()):
        for li, pk, A, B in parse_lora_factors(params, cfg, adapter_dir, label=name):
            factors.setdefault((li, pk), {})[idx] = (A, B)
    dtype = param_dtype(cfg)
    n = len(names)
    for (li, pk), per in factors.items():
        lp = params["layers"][li]
        kernel = lp[pk]["kernel"]
        in_f = kernel.shape[0]
        w = per[next(iter(per))][1].shape[1]
        r_max = max(a.shape[1] for a, _ in per.values())
        A_st = np.zeros((n, in_f, r_max), np.float32)
        B_st = np.zeros((n, r_max, w), np.float32)
        for idx, (A, B) in per.items():
            A_st[idx, :, :A.shape[1]] = A
            B_st[idx, :B.shape[0], :] = B
        lp[pk]["lora"] = {"A": torch.from_numpy(A_st).to(dtype).to(kernel.device),
                          "B": torch.from_numpy(B_st).to(dtype).to(kernel.device)}
    return names
