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
  n_out) and DeepSeek's ``shared`` experts.

- :func:`load_hf_checkpoint` reads a local HuggingFace safetensors
  directory (one file or index-sharded) with the port's own parser
  (:func:`read_safetensors`) and maps its names as the JAX loader does,
  leaf by leaf onto the device.
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
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


def _check_family(cfg: ModelConfig) -> None:
    if cfg.is_mla:
        raise NotImplementedError(
            f"{cfg.name}: the MLA family is not ported yet "
            "(ROADMAP.md A8, model breadth)")


def params_from_numpy(tree, cfg: ModelConfig, device) -> dict:
    """The JAX package's parameter tree, as numpy arrays, on ``device`` in
    the model's dtype (an MoE ``router_bias`` stays float32, as there)."""
    _check_family(cfg)
    dtype = param_dtype(cfg)

    def conv(x, leaf_dtype=dtype):
        if isinstance(x, dict):
            return {k: conv(v, torch.float32 if k == "router_bias" else leaf_dtype)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, leaf_dtype) for v in x]
        arr = np.array(x)                      # a writable host copy
        if arr.dtype.name == "bfloat16":       # ml_dtypes: go through float32
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(leaf_dtype).to(device)
    return conv(tree)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random-normal parameters, equal to the JAX package's
    ``init_params(cfg, seed)`` value for value (dense, norm and MoE leaves;
    MLA raises)."""
    _check_family(cfg)
    rng = np.random.default_rng(seed)
    dtype = param_dtype(cfg)

    def normal(shape, scale):
        # draw and scale in numpy, cast on the host: the rounding the
        # test pins (float32 draws, the JAX init's arithmetic)
        return torch.from_numpy(scale(rng.standard_normal(shape, dtype=np.float32))).to(
            dtype).to(device)
    return _init_tree(cfg, normal, dtype, device)


def init_params_device(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random-normal parameters with :func:`init_params`' tree, shapes,
    dtypes and scales, drawn on ``device`` by a seeded ``torch.Generator``:
    seconds for tens of billions of values where host draws take minutes,
    but not the JAX init's numbers."""
    _check_family(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = param_dtype(cfg)

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return scale(x).to(dtype)
    return _init_tree(cfg, normal, dtype, device)


def _init_tree(cfg: ModelConfig, normal, dtype, device) -> dict:
    """The JAX init's tree, in its draw order: ``normal(shape, scale)``
    draws a float32 standard normal of ``shape``, applies ``scale`` and
    returns it in the model's dtype on ``device``."""
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
        layers.append(lp)

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

    def __init__(self, ckpt_dir: str):
        self.files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
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


def load_hf_checkpoint(cfg: ModelConfig, ckpt_dir: str, device="cuda") -> dict:
    """An HF checkpoint directory as the transformer's parameter tree, the
    JAX loader's names and layouts (``tpuserve/models/weights.py``):
    linear kernels ``(out, in)`` -> ``(in, out)``, Phi-3's fused
    ``qkv_proj`` and ``gate_up_proj`` split, Qwen3's q/k norms, Gemma2's
    sandwich norms, no ``lm_head`` with tied embeddings, OPT's learned
    positions and layernorm biases.  Each leaf is copied to ``device`` in
    the model's dtype before the next is read, so the host never holds the
    model twice."""
    _check_family(cfg)
    dtype = param_dtype(cfg)
    device = torch.device(device)
    with read_safetensors(ckpt_dir) as raw:
        if cfg.pos == "learned":
            return _load_opt(cfg, raw, dtype, device)
        return _load_llama_family(cfg, raw, dtype, device)


def _put(w: torch.Tensor, dtype, device, t: bool = False) -> torch.Tensor:
    """One leaf on the device in ``dtype`` (transposed from HF's (out, in)
    to (in, out) when ``t``), never a view of the mapped file."""
    w = w.to(device=device, dtype=dtype, copy=True)
    return w.T.contiguous() if t else w


def _load_llama_family(cfg: ModelConfig, raw: SafetensorsDir, dtype, device) -> dict:
    def dense(name, bias_name=None):
        p = {"kernel": _put(raw[name], dtype, device, t=True)}
        if bias_name and bias_name in raw:
            p["bias"] = _put(raw[bias_name], dtype, device)
        return p

    def norm_scale(name):
        return {"scale": _put(raw[name], dtype, device)}

    def split(name, sizes):
        # a fused (out, in) projection: its row blocks, each as (in, out)
        return [{"kernel": _put(w, dtype, device, t=True)}
                for w in torch.split(raw[name], sizes, dim=0)]

    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        lp = {"attn_norm": norm_scale(pre + "input_layernorm.weight"),
              "o_proj": dense(pre + "self_attn.o_proj.weight")}
        if cfg.sandwich_norms:
            # Gemma2: post_attention_layernorm wraps the attention output;
            # the MLP pre-norm is pre_feedforward_layernorm
            lp["post_attn_norm"] = norm_scale(pre + "post_attention_layernorm.weight")
            lp["mlp_norm"] = norm_scale(pre + "pre_feedforward_layernorm.weight")
            lp["post_mlp_norm"] = norm_scale(pre + "post_feedforward_layernorm.weight")
        else:
            lp["mlp_norm"] = norm_scale(pre + "post_attention_layernorm.weight")
        if pre + "self_attn.qkv_proj.weight" in raw:            # Phi-3 fused qkv
            lp["q_proj"], lp["k_proj"], lp["v_proj"] = split(
                pre + "self_attn.qkv_proj.weight", [cfg.q_size, cfg.kv_size, cfg.kv_size])
        else:
            for proj in ("q", "k", "v"):
                lp[f"{proj}_proj"] = dense(pre + f"self_attn.{proj}_proj.weight",
                                           pre + f"self_attn.{proj}_proj.bias")
        if cfg.qk_norm:
            lp["q_norm"] = norm_scale(pre + "self_attn.q_norm.weight")
            lp["k_norm"] = norm_scale(pre + "self_attn.k_norm.weight")
        if cfg.num_experts and not cfg.moe_layer_is_dense(i):   # Qwen3 / DeepSeek MoE
            lp.update(_load_moe_layer(cfg, raw, pre, dtype, device))
        elif pre + "mlp.gate_up_proj.weight" in raw:            # Phi-3 fused mlp
            lp["gate_proj"], lp["up_proj"] = split(
                pre + "mlp.gate_up_proj.weight", [cfg.intermediate_size] * 2)
            lp["down_proj"] = dense(pre + "mlp.down_proj.weight")
        else:
            lp["gate_proj"] = dense(pre + "mlp.gate_proj.weight")
            lp["up_proj"] = dense(pre + "mlp.up_proj.weight")
            lp["down_proj"] = dense(pre + "mlp.down_proj.weight")
        layers.append(lp)
    params = {"embed": {"weight": _put(raw["model.embed_tokens.weight"], dtype, device)},
              "layers": layers,
              "final_norm": norm_scale("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense("lm_head.weight")
    return params


def _load_moe_layer(cfg: ModelConfig, raw: SafetensorsDir, pre: str, dtype, device) -> dict:
    """One MoE layer's router (and float32 selection bias), its experts
    stacked (E, n_in, n_out) on the device one expert at a time (no host
    copy of a whole stack), and its shared experts."""
    E, h, ei = cfg.num_experts, cfg.hidden_size, cfg.expert_intermediate_size
    lp = {"router": {"kernel": _put(raw[pre + "mlp.gate.weight"], dtype, device, t=True)}}
    if cfg.moe_router_bias:
        lp["router_bias"] = {"bias": _put(raw[pre + "mlp.gate.e_score_correction_bias"],
                                          torch.float32, device)}
    experts = {}
    for proj, shape in (("gate_proj", (h, ei)), ("up_proj", (h, ei)), ("down_proj", (ei, h))):
        w = torch.empty((E, *shape), dtype=dtype, device=device)
        for e in range(E):
            w[e] = _put(raw[pre + f"mlp.experts.{e}.{proj}.weight"], dtype, device, t=True)
        experts[proj] = {"kernel": w}
    lp["experts"] = experts
    if cfg.moe_shared_experts:
        lp["shared"] = {proj: {"kernel": _put(raw[pre + f"mlp.shared_experts.{proj}.weight"],
                                              dtype, device, t=True)}
                        for proj in ("gate_proj", "up_proj", "down_proj")}
    return lp


def _load_opt(cfg: ModelConfig, raw: SafetensorsDir, dtype, device) -> dict:
    def get(name):
        # OPT checkpoints may or may not carry the "model." prefix
        for cand in (name, "model." + name):
            if cand in raw:
                return raw[cand]
        raise KeyError(name)

    def dense(name):
        p = {"kernel": _put(get(name + ".weight"), dtype, device, t=True)}
        try:
            p["bias"] = _put(get(name + ".bias"), dtype, device)
        except KeyError:
            pass
        return p

    def norm(name):
        return {"scale": _put(get(name + ".weight"), dtype, device),
                "bias": _put(get(name + ".bias"), dtype, device)}

    layers = []
    for i in range(cfg.num_layers):
        pre = f"decoder.layers.{i}."
        layers.append({
            "attn_norm": norm(pre + "self_attn_layer_norm"),
            "q_proj": dense(pre + "self_attn.q_proj"),
            "k_proj": dense(pre + "self_attn.k_proj"),
            "v_proj": dense(pre + "self_attn.v_proj"),
            "o_proj": dense(pre + "self_attn.out_proj"),
            "mlp_norm": norm(pre + "final_layer_norm"),
            "fc1": dense(pre + "fc1"),
            "fc2": dense(pre + "fc2"),
        })
    return {"embed": {"weight": _put(get("decoder.embed_tokens.weight"), dtype, device)},
            "pos_embed": {"weight": _put(get("decoder.embed_positions.weight"),
                                         dtype, device)},
            "layers": layers,
            "final_norm": norm("decoder.final_layer_norm")}


def load_or_init(cfg: ModelConfig, ckpt_dir: str | None, seed: int = 0,
                 device="cuda") -> dict:
    """The checkpoint in ``ckpt_dir`` when it holds ``*.safetensors``, else
    random init from ``seed`` (the JAX package's rule), which is logged."""
    if ckpt_dir and glob.glob(os.path.join(ckpt_dir, "*.safetensors")):
        logger.info("loading checkpoint %s", ckpt_dir)
        return load_hf_checkpoint(cfg, ckpt_dir, device)
    logger.info("no *.safetensors in %s: random init of %s from seed %d",
                ckpt_dir, cfg.name, seed)
    return init_params(cfg, seed, device)
