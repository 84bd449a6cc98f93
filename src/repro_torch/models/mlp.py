"""Dense MLP blocks (GLU variants, squared-ReLU, plain GELU); PyTorch port
of ``repro.models.mlp``."""
from __future__ import annotations

from ..distributed import sharding as sh
from .common import ParamDesc, activation, is_glu


def mlp_descs(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    descs = {
        "w_in": ParamDesc((d, f), ("embed", "mlp")),
        "w_out": ParamDesc((f, d), ("mlp", "embed")),
    }
    if is_glu(cfg.mlp_act):
        descs["w_gate"] = ParamDesc((d, f), ("embed", "mlp"))
    return descs


def mlp_forward(p, x, cfg, tp_mesh=None):
    """``tp_mesh``: the channels are split over its 'model' axis (``w_in``
    and ``w_gate`` column-parallel, ``w_out`` row-parallel), so the partial
    outputs are summed over 'model' (forward only)."""
    h = x @ p["w_in"].to(x.dtype)
    if is_glu(cfg.mlp_act):
        g = x @ p["w_gate"].to(x.dtype)
        h = activation(cfg.mlp_act, h, g)
    else:
        h = activation(cfg.mlp_act, h)
    out = h @ p["w_out"].to(x.dtype)
    return out if tp_mesh is None else sh.tp_reduce(out, tp_mesh)
