"""Port parity for the mesh round (``core.distributed.make_round_fn``): the
port on a 2×2 gloo process mesh (``launch.mesh.run_on_mesh``, four
processes on the CPU) against the reference's ``make_round_fn`` under
``shard_map`` on a forced 4-device ``make_host_mesh(2, 2)`` in a
subprocess, both from the reference's initial state, bit for bit.

The port is fed the reference's draws through ``make_round_fn(streams=)``
(:class:`ReferenceMeshStreams`): round r passes ``fold_in(key, r)``,
client c keys ``split(·, n_clients)[c]`` and its sweep s ``fold_in(·,
s)``; a sorted chunk ch draws ``ops._step_uniforms(fold_in(key_s, ch),
…)`` at the reference's padded length, a scan sweep
``tests/test_torch_scan.py::_sweep_draws`` of its key, and the top-k
filter's statistic i ``randint(fold_in(fold_in(key_c, 7), i), …)``.
Tolerance: none.  At K = 8 the two packages' alias tables, row sums and
chains agree (``tests/test_torch_scan_trainer.py``) and every count is a
float32 integer, so after each round every rank's z, n_dk (PDP's r,
HDP's m_dk), every shared statistic, the clocks, SSP's cache version and
lag and the per-shard row mass must equal the reference's.

This file: LDA on the scan layout under Algorithm 2 with a dead client
in the last round, under Algorithm 1 (two server shards) and under
SSP(1); and one in-process case, the reference on ``make_host_mesh(1,
1)`` against the port at world size 1.
``tests/test_torch_mesh_families.py`` runs the top-k filter, the sorted
layout, PDP, HDP and ``sync_compressed`` (the files split the reference's
compiles between two test workers).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_distributed
from repro.core import family as ref_family
from repro.core import ps as ref_ps
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.core import distributed, family, mhw, ps
from repro_torch.launch.mesh import run_on_mesh
from tests.conftest import make_family_cfg, make_synthetic_corpus
from tests.test_torch_scan import _sweep_draws

V, K, D, L, SEED = 64, 8, 16, 16, 7
ROOT = Path(__file__).resolve().parents[1]
LIVE, DEAD1 = [1, 1], [1, 0]

# name: family, DistConfig fields, alive flags of each round
SCENARIOS = {
    "lda-alg2-dead": ("lda", {}, [LIVE, LIVE, DEAD1]),
    "lda-alg1": ("lda", {"n_server_shards": 2}, [LIVE, LIVE]),
    "lda-ssp1": ("lda", {"consistency": "ssp:1"}, [LIVE, LIVE, LIVE]),
}

SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from tests.test_torch_mesh_parity import reference_run
reference_run(sys.argv[1], sys.argv[2])
"""


def corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=V, n_docs=D,
                                            doc_len=L, seed=3)
    return np.asarray(tokens), np.asarray(mask)


def refresh_due(policy, r: int, version) -> bool:
    """The reference test's proposal schedule: every round, or under SSP
    at round 0 and whenever the cache is due a refresh."""
    return (not policy.caches or r == 0
            or policy.needs_refresh(r, int(version)))


def _record(out: dict, prefix: str, local, stats, state) -> None:
    """One round's observables as numpy arrays under ``prefix``."""
    def host(x):
        return (x.detach().cpu().numpy() if torch.is_tensor(x)
                else np.asarray(x))
    for f, v in local._asdict().items():
        out[f"{prefix}/local/{f}"] = host(v)
    for n, v in stats.items():
        out[f"{prefix}/stats/{n}"] = host(v)
    out[f"{prefix}/clocks"] = host(state.clocks)
    out[f"{prefix}/cache_version"] = np.asarray(int(state.cache_version))
    for n, v in (state.client_lag or {}).items():
        out[f"{prefix}/lag/{n}"] = host(v)
    out[f"{prefix}/row_mass"] = np.concatenate(
        [host(m) for m in state.row_mass])


def _dist_kw(dist: dict, ps_mod) -> dict:
    kw = dict(dist)
    if "filter" in kw:
        kw["filter"] = ps_mod.FilterSpec(**kw["filter"])
    return kw


# ------------------------------------------------------------ the reference
def reference_run(spec_path: str, out_path: str) -> None:
    """The reference's mesh rounds of every scenario of the spec (and
    ``sync_compressed`` when it asks), written to one npz."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_host_mesh

    spec = json.loads(Path(spec_path).read_text())
    data = np.load(spec["corpus"])
    tokens, mask = jnp.asarray(data["tokens"]), jnp.asarray(data["mask"])
    mesh = make_host_mesh(*spec["mesh"])
    out: dict[str, np.ndarray] = {}
    for name, sc in spec["scenarios"].items():
        rcfg = make_family_cfg(sc["family"], n_topics=K, vocab_size=V)
        rfam = ref_family.get(sc["family"])
        dcfg = ref_distributed.DistConfig(model=sc["family"],
                                          **_dist_kw(sc["dist"], ref_ps))
        server = ref_distributed.make_server(rcfg, dcfg)
        key = jax.random.PRNGKey(SEED)
        local, shared = rfam.init_state(rcfg, tokens, mask, key)
        state = server.init_state(shared, n_clients=spec["mesh"][0])
        round_fn = ref_distributed.make_round_fn(rcfg, dcfg, mesh,
                                                 server=server)
        for r, alive in enumerate(sc["alive"]):
            if refresh_due(server.policy, r, state.cache_version):
                state = server.refresh_proposal(rcfg, state)
            local, state = round_fn(local, state, tokens, mask,
                                    jax.random.fold_in(key, r),
                                    jnp.asarray(alive, bool))
            stats = {n: np.asarray(v) for n, v in
                     rfam.stats_dict(server.snapshot(state)).items()}
            _record(out, f"{name}/r{r}", local, stats, state)
    if "sync" in spec:
        sync = spec["sync"]
        mesh4 = make_host_mesh(sync["ranks"], 1)
        fspec = ref_ps.FilterSpec(**sync["filter"])
        fn = shard_map(
            lambda d, k: ref_distributed.sync_compressed(d[0], fspec, k[0]),
            mesh=mesh4, in_specs=(P("data"), P("data")), out_specs=P(),
            check_rep=False)
        out["sync"] = np.asarray(fn(jnp.asarray(sync_deltas(sync)),
                                    sync_keys(sync)))
    np.savez(out_path, **out)


def start_reference(tmp_path: Path, scenarios: dict, mesh=(2, 2),
                    sync: dict | None = None):
    """Write the corpus and the spec, start :func:`reference_run` in a
    subprocess with ``mesh[0]·mesh[1]`` forced CPU devices; returns the
    spec and a callable that waits for it and loads its arrays."""
    tokens, mask = corpus()
    np.savez(tmp_path / "corpus.npz", tokens=tokens, mask=mask)
    spec = {"corpus": str(tmp_path / "corpus.npz"), "mesh": list(mesh),
            "scenarios": {n: {"family": f, "dist": d, "alive": a}
                          for n, (f, d, a) in scenarios.items()}}
    if sync is not None:
        spec["sync"] = sync
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "spec.json"),
         str(tmp_path / "ref.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait() -> dict:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        return dict(np.load(tmp_path / "ref.npz"))

    return spec, wait


# ---------------------------------------------------------- the port's side
def reference_init(fam_name: str) -> dict:
    """The reference's initial local state and statistics, as numpy."""
    tokens, mask = corpus()
    rcfg = make_family_cfg(fam_name, n_topics=K, vocab_size=V)
    local, shared = ref_family.get(fam_name).init_state(
        rcfg, jnp.asarray(tokens), jnp.asarray(mask),
        jax.random.PRNGKey(SEED))
    return {"local": {f: np.asarray(v) for f, v in local._asdict().items()},
            "shared": {f: np.asarray(v)
                       for f, v in shared._asdict().items()}}


def reference_draws(fam_name: str, dist: dict, rounds: int,
                    n_clients: int) -> tuple[dict, dict]:
    """Each sweep's draws, keyed (round, client, sweep), and the top-k
    filter's random rows, keyed (round, client, statistic), as the
    reference's mesh round draws them."""
    tokens, mask = corpus()
    rcfg = make_family_cfg(fam_name, n_topics=K, vocab_size=V)
    rfam = ref_family.get(fam_name)
    per, e = D // n_clients, rfam.n_outcomes(rcfg)
    filt = dist.get("filter", {})
    key = jax.random.PRNGKey(SEED)
    sweeps, rows = {}, {}
    for r in range(rounds):
        keys = jax.random.split(jax.random.fold_in(key, r), n_clients)
        for c in range(n_clients):
            key_s = jax.random.fold_in(keys[c], 0)
            if dist.get("layout") == "sorted":
                lays = rfam.build_sorted_layouts(
                    rcfg, jnp.asarray(tokens[c * per:(c + 1) * per]),
                    jnp.asarray(mask[c * per:(c + 1) * per]))
                sweeps[r, c, 0] = [tuple(np.asarray(u) for u in
                                         ref_ops._step_uniforms(
                    jax.random.fold_in(key_s, ch), e, rcfg.mh_steps,
                    int(lay.rows.shape[0]))) for ch, lay in enumerate(lays)]
            else:
                sweeps[r, c, 0] = [np.asarray(a) for a in _sweep_draws(
                    key_s, L, per, e, rcfg.mh_steps)]
            if filt.get("kind") == "topk" and filt.get("random_rows"):
                kf = jax.random.fold_in(keys[c], 7)
                for i in range(len(rfam.delta_names)):
                    rows[r, c, i] = np.asarray(jax.random.randint(
                        jax.random.fold_in(kf, i), (filt["random_rows"],),
                        0, V, jnp.int32))
    return sweeps, rows


class ReferenceMeshStreams(distributed.MeshStreams):
    """The reference's draws of round ``self.round`` (set by the caller
    before each round)."""

    def __init__(self, sweeps: dict, rows: dict, mh_steps: int):
        self.sweeps, self.rows, self.steps = sweeps, rows, mh_steps
        self.round = 0

    def sweep_draws(self, layout, c, tau):
        return [self._callback(layout, self.sweeps[self.round, c, s])
                for s in range(tau)]

    def _callback(self, layout, d):
        if layout == "sorted":
            return lambda ch, lay, tile_b: tuple(torch.as_tensor(u)
                                                 for u in d[ch])
        return lambda i: [mhw.StepDraws(*(torch.as_tensor(a[i, s])
                                          for a in d))
                          for s in range(self.steps)]

    def random_rows(self, c, i):
        rows = self.rows.get((self.round, c, i))
        return None if rows is None else torch.as_tensor(rows)


def port_rank(mesh, dev, spec: dict, inputs: dict) -> dict:
    """One rank of the port's mesh: every scenario's rounds, recorded."""
    n_clients = mesh.shape[0]
    c = mesh.get_local_rank("data")
    per = D // n_clients
    docs = slice(c * per, (c + 1) * per)
    data = np.load(spec["corpus"])
    tok = torch.as_tensor(data["tokens"][docs], device=dev)
    msk = torch.as_tensor(data["mask"][docs], device=dev)
    out = {}
    for name, sc in spec["scenarios"].items():
        fam = family.get(sc["family"])
        cfg = bridge.config_from(make_family_cfg(sc["family"], n_topics=K,
                                                 vocab_size=V))
        dcfg = distributed.DistConfig(model=sc["family"],
                                      **_dist_kw(sc["dist"], ps))
        server = distributed.make_server(cfg, dcfg)
        init, (sweeps, rows) = inputs[name]
        local = bridge.local_from({f: v[docs] for f, v in
                                   init["local"].items()}, device=dev,
                                  kind=fam)
        state = server.init_state(bridge.shared_from(
            init["shared"], device=dev, kind=fam), n_clients)
        streams = ReferenceMeshStreams(sweeps, rows, cfg.mh_steps)
        round_fn = distributed.make_round_fn(cfg, dcfg, mesh, server=server,
                                             device=dev, streams=streams)
        rec: dict[str, np.ndarray] = {}
        for r, alive in enumerate(sc["alive"]):
            if refresh_due(server.policy, r, state.cache_version):
                state = server.refresh_proposal(cfg, state)
            streams.round = r
            local, state = round_fn(local, state, tok, msk, (SEED, r), alive)
            _record(rec, f"{name}/r{r}", local,
                    fam.stats_dict(server.assemble(state)), state)
        out.update(rec)
    return out


def port_inputs(spec: dict) -> dict:
    n_clients = spec["mesh"][0]
    return {name: (reference_init(sc["family"]), reference_draws(
        sc["family"], sc["dist"], len(sc["alive"]), n_clients))
        for name, sc in spec["scenarios"].items()}


def assert_ranks_equal_reference(spec: dict, ref: dict, ranks: list,
                                 name: str) -> None:
    """Every rank's record of scenario ``name`` equals the reference's, a
    client's local state against the reference's rows of that client's
    documents."""
    data, model = spec["mesh"]
    per = D // data
    want_keys = {k for k in ref if k.startswith(f"{name}/")}
    assert want_keys, name
    for rank, got in enumerate(ranks):
        c = rank // model
        docs = slice(c * per, (c + 1) * per)
        assert {k for k in got if k.startswith(f"{name}/")} == want_keys
        for k in sorted(want_keys):
            want = ref[k][docs] if "/local/" in k else ref[k]
            np.testing.assert_array_equal(got[k], want,
                                          err_msg=f"rank {rank} {k}")


def drift(z: np.ndarray, counts_wk: np.ndarray) -> float:
    """max |count_wk(z) − counts_wk|, the counts taken with numpy (PDP's
    customer counts m_wk count assignments as LDA's n_wk do)."""
    tokens, mask = corpus()
    counts = np.zeros((V, K), np.float32)
    np.add.at(counts, (tokens[mask], z[mask]), 1.0)
    return float(np.abs(counts - counts_wk).max())


# The statistic that counts each family's assignments.
N_WK = {"lda": "n_wk", "hdp": "n_wk", "pdp": "m_wk"}


def run_parity(tmp_path: Path, scenarios: dict, sync: dict | None = None
               ) -> tuple[dict, dict, list, list | None]:
    """The reference in a subprocess while the port runs on a 2×2 gloo
    mesh (and ``sync_compressed`` on four ranks, when asked); returns (the
    spec, the reference's arrays, the ranks' records, the ranks'
    ``sync_compressed`` results)."""
    spec, wait = start_reference(tmp_path, scenarios, sync=sync)
    ranks = run_on_mesh(port_rank, 2, 2, device="cpu",
                        args=(spec, port_inputs(spec)))
    synced = None
    if sync is not None:
        synced = run_on_mesh(sync_rank, sync["ranks"], 1, device="cpu",
                             args=(sync,))
    return spec, wait(), ranks, synced


def check_round(name: str, rounds: int, parity) -> tuple[str, dict]:
    """Every rank equals the reference; the chains moved; the port's count
    drift equals the reference's.  Returns the last round's key prefix
    and the reference's arrays."""
    spec, ref, ranks, _ = parity
    assert_ranks_equal_reference(spec, ref, ranks, name)
    last = f"{name}/r{rounds - 1}"
    z = ref[f"{last}/local/z"]
    assert (z != ref[f"{name}/r0/local/z"]).mean() > 0.1, "the chains moved"
    port_z = np.concatenate([ranks[0][f"{last}/local/z"],
                             ranks[2][f"{last}/local/z"]])
    assert drift(port_z, ranks[0][f"{last}/stats/{N_WK[name[:3]]}"]) \
        == drift(z, ref[f"{last}/stats/{N_WK[name[:3]]}"])
    return last, ref


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return run_parity(tmp_path_factory.mktemp("mesh_parity"), SCENARIOS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_round_equals_the_reference(name, parity):
    rounds = len(SCENARIOS[name][2])
    last, ref = check_round(name, rounds, parity)
    clocks = ref[f"{last}/clocks"].tolist()
    n_wk = ref[f"{last}/stats/n_wk"]
    if name == "lda-alg2-dead":
        # The dead client swept but pushed nothing: its clock stayed.
        assert clocks == [3, 2]
        assert drift(ref[f"{last}/local/z"], n_wk) > 0.0
        return
    assert clocks == [rounds, rounds]
    assert drift(ref[f"{last}/local/z"], n_wk) == 0.0
    if name == "lda-ssp1":
        assert int(ref[f"{last}/cache_version"]) == 2
        assert ref[f"{last}/lag/n_wk"].any()
    if name == "lda-alg1":
        assert ref[f"{last}/row_mass"].shape == (V,)
        assert ref[f"{last}/row_mass"].sum() > 0


def test_world_size_one_equals_the_reference_in_process(tmp_path):
    """The reference's round on ``make_host_mesh(1, 1)`` in this process
    against the port at world size 1, two LDA scan rounds."""
    scenarios = {"lda-1x1": ("lda", {}, [[1], [1]])}
    tokens, mask = corpus()
    np.savez(tmp_path / "corpus.npz", tokens=tokens, mask=mask)
    spec = {"corpus": str(tmp_path / "corpus.npz"), "mesh": [1, 1],
            "scenarios": {n: {"family": f, "dist": d, "alive": a}
                          for n, (f, d, a) in scenarios.items()}}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    reference_run(str(tmp_path / "spec.json"), str(tmp_path / "ref.npz"))
    ref = dict(np.load(tmp_path / "ref.npz"))
    ranks = run_on_mesh(port_rank, 1, 1, device="cpu",
                        args=(spec, port_inputs(spec)))
    assert_ranks_equal_reference(spec, ref, ranks, "lda-1x1")
    assert ref["lda-1x1/r1/clocks"].tolist() == [2]
    assert drift(ref["lda-1x1/r1/local/z"],
                 ref["lda-1x1/r1/stats/n_wk"]) == 0.0


def sync_deltas(sync: dict) -> np.ndarray:
    """Each rank's integer (V, K) delta for the ``sync_compressed`` case."""
    rng = np.random.default_rng(sync["seed"])
    return rng.integers(-3, 4, size=(sync["ranks"], V, K)).astype(
        np.float32)


def sync_keys(sync: dict):
    return jax.random.split(jax.random.PRNGKey(sync["seed"]), sync["ranks"])


def sync_rows(sync: dict) -> np.ndarray:
    """Each rank's random filter rows, the reference's draw from its key."""
    return np.stack([np.asarray(jax.random.randint(
        k, (sync["filter"]["random_rows"],), 0, V, jnp.int32))
        for k in sync_keys(sync)])


def sync_rank(mesh, dev, sync: dict) -> np.ndarray:
    """One rank's ``sync_compressed`` of its delta over the data group."""
    c = mesh.get_local_rank("data")
    return distributed.sync_compressed(
        torch.as_tensor(sync_deltas(sync)[c], device=dev),
        ps.FilterSpec(**sync["filter"]), (sync["seed"], c),
        mesh.get_group("data"),
        random_rows=torch.as_tensor(sync_rows(sync)[c])).cpu().numpy()
