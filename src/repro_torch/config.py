"""Model configuration of the port (counterpart of ``repro/config.py``).

``ModelConfig`` is a copy of the reference's dataclass with its derived
properties, so a config of either package describes the same model. It
spans every architecture family of the reference; the port runs the
dense families (``configs/registry.py`` lists them). ``MeshConfig``
is the reference's too: the elastic fleet's ``remesh_plan`` and
``remesh_fleet`` return it, and a ``RunConfig`` names one. The shapes
(``ShapeConfig``, ``SHAPES``), ``TrainConfig`` and ``RunConfig`` are
copies of the reference's, with the same defaults; ``RunConfig`` has
no ``use_pallas``, which only the reference's dry run reads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads

    # --- normalization ---
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5

    # --- attention ---
    attn_type: str = "gqa"           # gqa | mla | swa | none
    sliding_window: int = 0          # >0 with attn_type == "swa"
    rope_theta: float = 10_000.0
    qkv_bias: bool = False           # qwen-style bias on qkv
    qk_norm: bool = False

    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # MoE on layers where (i % moe_every == moe_every - 1)
    first_k_dense: int = 0           # leading dense layers (deepseek)
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    dispatch_mode: str = "1s"        # "1s" decoupled (paper) | "2s" bulk baseline
    dispatch_groups: int = 4         # chunking for the 1s decoupled schedule
    router_aux_coef: float = 0.01
    expert_tp_axis: str = ""         # shard expert d_ff over this mesh axis
                                     #   (serving: TP-within-expert, no FSDP)

    # --- hybrid (jamba): attention layer every attn_every layers, at attn_offset
    attn_every: int = 0
    attn_offset: int = 0

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq_factor: int = 1          # encoder seq = decoder seq * factor (stub frontend)

    # --- modality frontend stubs ---
    frontend: str = "none"           # none | audio_stub | vision_stub

    # --- numerics / embedding ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- block scan structure ---
    block_pattern: int = 1           # layers per scanned super-block

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads > 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # ---- derived ----
    @property
    def n_scan_blocks(self) -> int:
        core = self.n_layers - self.first_k_dense
        assert core % self.block_pattern == 0, (self.name, core, self.block_pattern)
        return core // self.block_pattern

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_k_dense:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid stacks: which layers carry attention (vs SSM)."""
        if self.family != "hybrid":
            return self.attn_type != "none"
        return (i % self.attn_every) == self.attn_offset

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in ("ssm", "hybrid") or self.attn_type == "swa"

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory napkin math)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_dec = self.n_layers
        for i in range(n_dec):
            total += self._layer_params(i)
            if self.n_enc_layers:        # enc-dec: cross-attn + its norm
                total += self._attn_params(cross=True) + d
        for _ in range(self.n_enc_layers):
            total += self._attn_params(cross=False) + 3 * d * ff + 2 * d
        total += d                        # enc final norm
        return total if self.n_enc_layers else total - d

    def active_param_count(self) -> int:
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            total += self._layer_params(i, active=True)
            if self.n_enc_layers:
                total += self._attn_params(cross=True) + d
        for _ in range(self.n_enc_layers):
            total += self._attn_params(cross=False) + 3 * d * self.d_ff + 2 * d
        return total

    def _attn_params(self, cross: bool = False) -> int:
        d = self.d_model
        if self.attn_type == "mla":
            # q: d->H*(nope+rope); kv down: d->kv_lora + rope; up: kv_lora->H*(nope+v)
            H = self.n_heads
            q = d * H * (self.qk_nope_dim + self.qk_rope_dim)
            kvd = d * (self.kv_lora_rank + self.qk_rope_dim)
            kvu = self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim)
            o = H * self.v_head_dim * d
            return q + kvd + kvu + o
        hd = self.d_head
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        conv_dim = di + 2 * self.ssm_groups * self.ssm_state
        inproj = d * (2 * di + 2 * self.ssm_groups * self.ssm_state + self.n_ssm_heads)
        conv = self.ssm_conv * conv_dim
        out = di * d
        extra = 2 * self.n_ssm_heads + di  # A_log, D, gate norm
        return inproj + conv + out + extra

    def _layer_params(self, i: int, active: bool = False) -> int:
        d = self.d_model
        total = 2 * d  # norms (rms scale x2); nonparam -> 0 but negligible
        if self.family == "ssm" or (self.family == "hybrid" and not self.is_attn_layer(i)):
            total += self._ssm_params()
        else:
            total += self._attn_params()
        if self.family == "ssm":
            return total
        if self.is_moe_layer(i):
            ffe = self.d_ff_expert or self.d_ff
            n_e = (self.top_k if active else self.n_experts)
            total += 3 * d * ffe * (n_e + self.n_shared_experts)
            total += d * self.n_experts  # router
        else:
            total += 3 * d * self.d_ff
        return total


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def dp_size(self) -> int:
        n = 1
        for s, a in zip(self.shape, self.axes):
            if a in ("pod", "data"):
                n *= s
        return n

    @property
    def tp_size(self) -> int:
        for s, a in zip(self.shape, self.axes):
            if a == "model":
                return s
        return 1


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Shapes (assigned cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Train / run
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    moment_dtype: str = "float32"        # "bfloat16" for the big archs
    accum_dtype: str = "float32"         # grad-accum buffer
    grad_accum: int = 1
    remat_policy: str = "full"           # full | dots | none
    decoupled_grad_sync: bool = True     # per-layer reduce-scatter (sharded)
    compress_cross_pod: bool = False     # int8 error-feedback on pod axis
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD
    train: TrainConfig = field(default_factory=TrainConfig)
    microbatch: int = 0                  # 0 -> auto

    def resolved_microbatch(self) -> int:
        if self.microbatch:
            return self.microbatch
        if not self.shape.is_train:
            return self.shape.global_batch
        # Bound live logits: keep ~<=128k tokens per microbatch globally.
        target = 131_072
        mb = max(1, min(self.shape.global_batch,
                        target // max(1, self.shape.seq_len)))
        while self.shape.global_batch % mb:
            mb -= 1
        return mb

    @property
    def grad_accum_steps(self) -> int:
        if not self.shape.is_train:
            return 1
        return self.shape.global_batch // self.resolved_microbatch()


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
