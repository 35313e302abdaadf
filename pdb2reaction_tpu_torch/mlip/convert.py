"""eSCN-MoE (UMA-class) checkpoint conversion: a fairchem-style torch
state dict -> the port's parameter tree.

Counterpart of ``pdb2reaction_tpu/mlip/convert.py``, with the same name
map:

- ``convert_state_dict(sd, cfg)``: the fairchem-style names onto the
  eSCN tree layout (``mlip/escn.py``): a torch Linear ``[out, in]``
  becomes ``{"w": [in, out], "b": [out]}``, a MoLE stack
  ``[experts, out, in]`` becomes ``w: [experts, in, out]``. The tree is
  built in numpy as the JAX package builds it and carried into tensors
  by ``from_jax.params_from_jax``, so both packages read a checkpoint
  into the same numbers.
- ``infer_config(sd)``: the port's ``ESCNConfig`` (lmax, mmax, widths,
  layers, experts, ...) from the tensor shapes alone.
- ``load_torch_checkpoint(path)``: ``torch.load`` of a ``.pt`` file,
  with wrapper prefixes stripped and the spellings of real fairchem
  layouts normalized (``_SYNONYMS``).

A tensor the conversion does not consume raises, a missing one raises
``KeyError``: a partial conversion never passes for a whole one
(``audit_checkpoint`` reports both without raising). Gate-activation
weights (``backbone.blocks.N.gate.{weight,bias}``, which also make
``infer_config`` pick ``edge_act="gate"``) go into each block's ``gate``
MoLE bank, as in the JAX package's converter.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .escn import ESCNConfig
from .from_jax import params_from_jax

def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


# Spellings of real fairchem key layouts, normalized to the canonical
# names the conversion consumes (docs/fairchem_name_map.md)
_SYNONYMS = [
    # SO2_Convolution holds the m >= 1 pairs in a ModuleList so2_m_conv
    # indexed from 0 (m = index + 1) with fc_r / fc_i members
    (re.compile(r"\.so2_m_conv\.(\d+)\.fc_r\."),
     lambda m: f".fc_m{int(m.group(1)) + 1}_r."),
    (re.compile(r"\.so2_m_conv\.(\d+)\.fc_i\."),
     lambda m: f".fc_m{int(m.group(1)) + 1}_i."),
    # embedding modules that carry an inner .embedding attribute
    (re.compile(r"(sphere|source|target|charge|spin|task)"
                r"_embedding\.embedding\.weight"),
     lambda m: f"{m.group(1)}_embedding.weight"),
]


def _strip(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Unwrap a {state_dict: ...} container, strip wrapper prefixes
    ('module.' DDP, 'model.' trainer wrappers), apply the spelling
    synonyms and ensure the 'backbone.' namespace."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    out = {}
    has_backbone = any(re.sub(r"^((module|model)\.)+", "", k)
                       .startswith("backbone.") for k in sd)
    for k, v in sd.items():
        k = re.sub(r"^((module|model)\.)+", "", k)
        for pat, rep in _SYNONYMS:
            k = pat.sub(rep, k)
        if not has_backbone and hasattr(v, "shape"):
            k = "backbone." + k
        out[k] = v
    return out


def load_torch_checkpoint(path) -> Dict[str, Any]:
    # weights_only: a checkpoint is data, and unpickling code from a file
    # would run it
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _strip(sd)


def inspect_checkpoint(path) -> Dict[str, Any]:
    """Tensor names and shapes of a .pt checkpoint."""
    out = {}
    for k, v in load_torch_checkpoint(path).items():
        try:
            out[k] = tuple(v.shape)
        except AttributeError:
            out[k] = type(v).__name__
    return out


def infer_config(sd: Mapping[str, Any], **overrides) -> ESCNConfig:
    """The ``ESCNConfig`` the tensor shapes imply; ``overrides`` set
    fields the shapes do not (``dtype``, ``edge_kernel``, ``cutoff``,
    ...)."""
    sd = _strip(sd)
    sph = _np(sd["backbone.sphere_embedding.weight"])
    max_z = sph.shape[0] - 1
    C = sph.shape[1]
    edge_ch = _np(sd["backbone.source_embedding.weight"]).shape[1]
    route_dim = _np(sd["backbone.charge_embedding.weight"]).shape[1]
    charge_range = (_np(sd["backbone.charge_embedding.weight"]).shape[0]
                    - 1) // 2
    spin_range = _np(sd["backbone.spin_embedding.weight"]).shape[0] - 1
    num_tasks = _np(sd["backbone.task_embedding.weight"]).shape[0]
    num_gauss = _np(sd["backbone.edge_mlp.0.weight"]).shape[1] - 2 * edge_ch
    E, dproj_out, _ = _np(sd["backbone.edge_degree_proj.weight"]).shape
    lmax = dproj_out // C - 1
    # mmax from the highest fc_m{m}_r of block 0
    mmax = 0
    for k in sd:
        m = re.match(r"backbone\.blocks\.0\.so2_conv_1\.fc_m(\d+)_r\.weight",
                     k)
        if m:
            mmax = max(mmax, int(m.group(1)))
    n_layers = 1 + max(int(re.match(r"backbone\.blocks\.(\d+)\.", k).group(1))
                       for k in sd if k.startswith("backbone.blocks."))
    h = _np(sd["backbone.blocks.0.so2_conv_1.fc_m0.weight"]).shape[1] \
        // (lmax + 1)
    ffn_hidden = _np(sd["backbone.blocks.0.ffn.w1.weight"]).shape[1]
    # gate weights mark the gate activation; without them the edge
    # activation is the parameter-free S2 one
    edge_act = ("gate" if "backbone.blocks.0.gate.weight" in sd else "s2")
    kw = dict(lmax=lmax, mmax=mmax, sphere_channels=C, hidden_channels=h,
              edge_channels=edge_ch, ffn_hidden=ffn_hidden,
              num_layers=n_layers, num_experts=E, route_dim=route_dim,
              num_gauss=num_gauss, max_z=max_z, charge_range=charge_range,
              spin_range=spin_range, num_tasks=num_tasks,
              edge_act=edge_act)
    kw.update(overrides)
    return ESCNConfig(**kw)


def _lin(sd, key):
    """torch nn.Linear -> {w: [in, out], b: [out]}."""
    return {"w": _np(sd[f"{key}.weight"]).T.copy(),
            "b": _np(sd[f"{key}.bias"]).copy()}


def _mole(sd, key):
    """MoLE stack [E, out, in] -> {w: [E, in, out], b: [E, out]}."""
    return {"w": _np(sd[f"{key}.weight"]).transpose(0, 2, 1).copy(),
            "b": _np(sd[f"{key}.bias"]).copy()}


def _so2(sd, key, cfg):
    p = {"fc_m0": _mole(sd, f"{key}.fc_m0")}
    for m in range(1, cfg.mmax + 1):
        p[f"fc_m{m}_r"] = _mole(sd, f"{key}.fc_m{m}_r")
        p[f"fc_m{m}_i"] = _mole(sd, f"{key}.fc_m{m}_i")
    return p


def convert_state_dict(sd: Mapping[str, Any], cfg=None, *,
                       consumed_out=None) -> Dict[str, Any]:
    """A whole fairchem-style eSCN-MoE state dict -> the port's parameter
    tree (CPU tensors in the checkpoint's own dtypes).

    ``cfg`` defaults to ``infer_config(sd)``. A missing tensor raises
    ``KeyError``; tensors left unconsumed raise ``ValueError``."""
    sd = _strip(sd)
    if cfg is None:
        cfg = infer_config(sd)
    consumed = set() if consumed_out is None else consumed_out

    class Tracking(dict):
        def __getitem__(self, k):
            consumed.add(k)
            return dict.__getitem__(self, k)

    tsd = Tracking(sd)
    params: Dict[str, Any] = {
        "sphere_embedding": _np(tsd["backbone.sphere_embedding.weight"]),
        "source_embedding": _np(tsd["backbone.source_embedding.weight"]),
        "target_embedding": _np(tsd["backbone.target_embedding.weight"]),
        "charge_embedding": _np(tsd["backbone.charge_embedding.weight"]),
        "spin_embedding": _np(tsd["backbone.spin_embedding.weight"]),
        "task_embedding": _np(tsd["backbone.task_embedding.weight"]),
        "router": [_lin(tsd, "backbone.router.0"),
                   _lin(tsd, "backbone.router.1")],
        "edge_mlp": [_lin(tsd, "backbone.edge_mlp.0"),
                     _lin(tsd, "backbone.edge_mlp.1")],
        "edge_degree_proj": _mole(tsd, "backbone.edge_degree_proj"),
        "blocks": [],
        "energy_norm": _np(tsd["backbone.energy_norm.weight"]),
        "energy_head": [_mole(tsd, "backbone.energy_head.0"),
                        _mole(tsd, "backbone.energy_head.1")],
        "atom_ref": _np(tsd["backbone.atom_ref"]),
    }
    for i in range(cfg.num_layers):
        b = f"backbone.blocks.{i}"
        blk = {
            "norm_1": _np(tsd[f"{b}.norm_1.weight"]),
            "so2_conv_1": _so2(tsd, f"{b}.so2_conv_1", cfg),
            "so2_conv_2": _so2(tsd, f"{b}.so2_conv_2", cfg),
            "norm_2": _np(tsd[f"{b}.norm_2.weight"]),
            "ffn": [_mole(tsd, f"{b}.ffn.w1"), _mole(tsd, f"{b}.ffn.w2")],
        }
        if cfg.edge_act == "gate":
            blk["gate"] = _mole(tsd, f"{b}.gate")
        params["blocks"].append(blk)
    leftovers = [k for k in sd
                 if k not in consumed and hasattr(sd[k], "shape")]
    if leftovers:
        raise ValueError(
            f"{len(leftovers)} checkpoint tensors were not consumed by the "
            f"conversion (first: {leftovers[:5]}); refusing a partial "
            "conversion")
    out = params_from_jax(params)
    # the routing inputs come from the caller (make_uma_calculator)
    for k in ("charge", "spin", "task"):
        out.pop(k)
    return out


def convert_checkpoint(path, **overrides):
    """(.pt path) -> (the port's parameter tree, ESCNConfig)."""
    sd = load_torch_checkpoint(path)
    cfg = infer_config(sd, **overrides)
    return convert_state_dict(sd, cfg), cfg


def audit_checkpoint(path) -> Dict[str, Any]:
    """The name map's audit of a .pt checkpoint, without raising:

    - ``mapped``: the tensors the conversion consumed;
    - ``unmapped``: tensors present but not consumed (layout drift: new
      fairchem module names needing a ``_SYNONYMS`` rule);
    - ``missing``: the first tensor the conversion needed and did not
      find (None when the conversion succeeded);
    - ``config``: the shape-inferred ESCNConfig;
    - ``ok``: missing is None and nothing is unmapped."""
    sd = load_torch_checkpoint(path)
    report: Dict[str, Any] = {"mapped": [], "unmapped": [],
                              "missing": None, "config": None}
    try:
        cfg = infer_config(sd)
        report["config"] = cfg
    except (KeyError, ValueError) as e:
        report["missing"] = str(e)
        report["unmapped"] = [k for k in sd if hasattr(sd[k], "shape")]
        return report
    consumed: set = set()
    try:
        convert_state_dict(sd, cfg, consumed_out=consumed)
    except KeyError as e:
        report["missing"] = str(e)
    except ValueError:
        pass  # the leftover refusal: reported through the sets below
    report["mapped"] = sorted(consumed)
    stripped = _strip(sd)
    report["unmapped"] = sorted(k for k in stripped
                                if k not in consumed
                                and hasattr(stripped[k], "shape"))
    report["ok"] = report["missing"] is None and not report["unmapped"]
    return report
