"""Roofline terms of a workload on a mesh of H100s (port of
``repro.launch.roofline``'s analytic model and ``Roofline`` record).

Three terms per (arch × shape × mesh), in seconds, one rank a card:

    compute    = FLOPs      / (chips × 989e12 dense bf16 FLOP/s)
    memory     = HBM bytes a card / 3.35e12 B/s
    collective = collective bytes a card / 450e9 B/s (NVLink 4, each way)

The denominators are ``launch/mesh.py``'s H100 SXM constants; the
collective term taken at NVLink's rate is a lower bound on a mesh that
spans nodes (NDR InfiniBand ~50 GB/s a GPU).

The FLOPs and HBM bytes come from the analytic workload model
(:func:`analytic_flops`, :func:`analytic_hbm_bytes`, :func:`model_flops`:
parameter matmuls, attention and SSM terms, optimizer and cache traffic),
the reference's functions, pure functions of the config and the shape.
The collective bytes are those the port's step calls on one rank, counted
by ``core.collectives.tally`` as the dry run runs it (their output bytes,
the measure the reference's HLO parse sums), not parsed from a compiled
program: torch has no HLO.  So the reference's HLO-only fields
(``hlo_flops``, ``hlo_bytes``, ``t_compute_hlo_s``, ``t_memory_hlo_s``,
``coll_loop_corrected``) are left out of :meth:`Roofline.row`, not faked.
Under megatron the port splits the block products over ``model`` as
XLA splits the reference's (``layers.tensor_parallel``), with collectives
of its own choosing (a re-layout of each weight to its compute split, the
activations' sums), so the bytes are the port's; the SSM mixers too are
split by heads, their served states kept in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def _attn_layers(cfg) -> float:
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers / max(cfg.attn_every, 1)
    if cfg.family == "audio":
        return cfg.n_layers            # decoder self-attn (cross added apart)
    return 0.0


def analytic_flops(cfg, shape) -> dict[str, float]:
    """Per-step global FLOPs: parameter matmuls + attention + SSM scan.

    Multipliers: forward = 1 pass; train = fwd + per-layer remat re-fwd +
    bwd = 4× forward matmul traffic (2·N → 8·N per token).
    """
    b, s = shape.global_batch, shape.seq_len
    n_act = cfg.active_param_count()
    h, hd = cfg.n_heads, cfg.head_dim_
    la = _attn_layers(cfg)

    def attn_fwd(sq, kv_len, causal=True):
        eff = (kv_len + 1) / 2 if (causal and kv_len == sq) else kv_len
        if cfg.sliding_window and kv_len > cfg.sliding_window:
            eff = min(eff, cfg.sliding_window)
        return 4.0 * b * sq * eff * h * hd * la

    ssm_fwd = 0.0
    if cfg.family == "ssm":
        ssm_fwd = 6.0 * cfg.n_layers * b * s * cfg.d_model * hd if hd else \
            6.0 * cfg.n_layers * b * s * cfg.d_model * 64
    if cfg.family == "hybrid":
        ssm_fwd = 6.0 * cfg.n_layers * b * s * cfg.d_model * cfg.ssm_state

    if shape.kind == "train":
        tokens = b * s
        mat = 8.0 * n_act * tokens                   # 2 fwd + 2 remat + 4 bwd
        attn = 4.0 * attn_fwd(s, s)
        extra = 4.0 * ssm_fwd
        if cfg.family == "audio":
            f = cfg.n_frames or 1500
            attn += 4.0 * (4.0 * b * s * f * h * hd * cfg.n_layers      # cross
                           + 4.0 * b * f * f * h * hd * cfg.encoder_layers)
        return {"flops": mat + attn + extra, "matmul": mat, "attn": attn}
    if shape.kind == "prefill":
        tokens = b * s
        mat = 2.0 * n_act * tokens
        attn = attn_fwd(s, s)
        if cfg.family == "audio":
            f = cfg.n_frames or 1500
            attn += (4.0 * b * s * f * h * hd * cfg.n_layers
                     + 4.0 * b * f * f * h * hd * cfg.encoder_layers)
        return {"flops": mat + attn + ssm_fwd, "matmul": mat, "attn": attn}
    # decode: one token per sequence
    mat = 2.0 * n_act * b
    kv_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
    if cfg.family == "ssm":
        attn = 0.0
    else:
        attn = 4.0 * b * kv_len * h * hd * la
    return {"flops": mat + attn + ssm_fwd / max(s, 1), "matmul": mat,
            "attn": attn}


def analytic_hbm_bytes(cfg, shape, chips: int, n_microbatches: int = 1
                       ) -> float:
    """Per-device HBM traffic per step (floor estimate)."""
    b, s = shape.global_batch, shape.seq_len
    p = cfg.param_count()
    d, l = cfg.d_model, cfg.n_layers
    if shape.kind == "train":
        # f32 master weights re-read per microbatch (fwd+bwd), optimizer
        # update ~6 passes (read g,m,v + write p,m,v), activations ~2 r/w of
        # one (tokens, d) tensor per layer in bf16 with remat.
        weights = p * 4.0 * (2.0 * n_microbatches + 6.0) / chips
        acts = 4.0 * l * b * s * d / chips
        return weights + acts
    if shape.kind == "prefill":
        weights = p * 2.0 / chips                    # bf16 serving weights
        acts = 4.0 * l * b * s * d / chips
        kv = 4.0 * l * b * s * cfg.n_kv_heads * cfg.head_dim_ / chips
        return weights + acts + kv
    # decode
    kv_len = min(s, cfg.sliding_window) if cfg.sliding_window else s
    weights = p * 2.0 / chips
    if cfg.family == "ssm":
        hd = cfg.head_dim_ or 64
        state = 4.0 * l * b * (d // max(hd, 1)) * hd * hd / chips
    elif cfg.family == "hybrid":
        state = 4.0 * l * b * d * cfg.ssm_state / chips \
            + 4.0 * (l / max(cfg.attn_every, 1)) * b * kv_len \
            * cfg.n_kv_heads * cfg.head_dim_ / chips
    else:
        state = 4.0 * l * b * kv_len * cfg.n_kv_heads * cfg.head_dim_ / chips
    return weights + state


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for forward-only (prefill)
    and 2·N per token for decode; N = active params."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token


@dataclass
class Roofline:
    """One workload's roofline: the analytic FLOPs (global) and HBM bytes
    (a card), and the collective bytes a rank's step called."""
    arch: str
    shape: str
    mesh: str
    chips: int
    coll_bytes: float
    model_flops: float
    analytic_flops_total: float = 0.0
    analytic_hbm: float = 0.0
    coll_by_kind: dict[str, int] = field(default_factory=dict)
    coll_counts: dict[str, int] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.analytic_flops_total / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.analytic_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        # the bytes are a rank's, one rank a card
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / analytic FLOPs — remat/attention overhead."""
        return (self.model_flops / self.analytic_flops_total
                if self.analytic_flops_total else 0.0)

    @property
    def step_time(self) -> float:
        """Roofline step-time lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline bound."""
        denom = self.step_time * self.chips * PEAK_FLOPS_BF16
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "analytic_flops": self.analytic_flops_total,
            "analytic_hbm_bytes_per_dev": self.analytic_hbm,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_step_s": self.step_time,
            "mfu_bound": self.mfu,
            "coll_by_kind": self.coll_by_kind,
            "coll_counts": self.coll_counts,
        }


def analyze(tally: dict, *, cfg, shape, mesh_name: str, chips: int,
            n_microbatches: int = 1) -> Roofline:
    """The record of one workload from the collectives' ``tally`` of a
    rank's step (``core.collectives.tally``)."""
    by_kind = {k: int(v["out_bytes"]) for k, v in tally.items()}
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        coll_bytes=float(sum(by_kind.values())),
        model_flops=model_flops(cfg, shape, shape.kind),
        analytic_flops_total=analytic_flops(cfg, shape)["flops"],
        analytic_hbm=analytic_hbm_bytes(cfg, shape, chips, n_microbatches),
        coll_by_kind=by_kind,
        coll_counts={k: int(v["calls"]) for k, v in tally.items()})
