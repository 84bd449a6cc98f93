"""Architecture config schema (the port's own copy of ``repro.configs.base``).

One ``ArchConfig`` instance per assigned architecture (exact configs live in
``all_archs``, reduced smoke configs via ``.reduced()``).  The schema is a
superset over the families: dense / MoE / SSM / hybrid / enc-dec / VLM /
audio.  ``block_pattern`` describes one period of the (possibly
heterogeneous) layer stack; the model is ``repeats`` stacked copies of that
period (+ optional unrolled prologue layers).  The port builds the dense
family (``repro_torch.models.model``); the registry is its own, so a config
registered here is unknown to the reference and the other way round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encdec|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // num_heads
    # one period of the layer stack; each entry is a layer kind:
    #   'attn' | 'local' | 'global' | 'mlstm' | 'slstm' | 'mamba'
    #   | 'mamba+shared_attn' | 'moe' | 'dense_ffn_attn'
    block_pattern: Tuple[str, ...] = ("attn",)
    prologue: Tuple[str, ...] = ()   # unrolled layers before the scan

    # attention details
    window_size: int = 1024          # for 'local' layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None

    # MLA (multi-head latent attention)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MLP
    mlp_act: str = "silu_glu"        # silu_glu|gelu_glu|squared_relu|gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0

    # SSM (mamba2) / xLSTM
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stubs
    frontend: Optional[str] = None   # None|'audio'|'vision'
    num_patches: int = 0             # vision: patch embeddings per example

    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # which shapes this arch runs (DESIGN.md §shape-skip)
    supports_long_context: bool = False
    has_decoder: bool = True

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def repeats(self) -> int:
        n_scanned = self.num_layers - len(self.prologue)
        if self.family == "encdec":
            return 1
        assert n_scanned % len(self.block_pattern) == 0, (
            f"{self.name}: {n_scanned} layers not divisible by pattern "
            f"{self.block_pattern}")
        return n_scanned // len(self.block_pattern)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = len(self.block_pattern)
        pro = len(self.prologue)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=pro + period,        # one period (+ prologue)
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads
            else 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            # deliberately asymmetric (qk = 12, v = 8) so head-dim mixups
            # are caught at smoke scale
            qk_nope_head_dim=8 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=4 if self.qk_rope_head_dim else 0,
            v_head_dim=8 if self.v_head_dim else 0,
            num_experts=min(self.num_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16,
            ssm_head_dim=16,
            ssm_chunk=32,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            window_size=32,
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
        )


_REGISTRY: dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import sibling modules lazily so `get_config` works standalone
    from . import all_archs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from . import all_archs  # noqa: F401
    return sorted(_REGISTRY)
