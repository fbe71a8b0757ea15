"""The port's LM train step over a 2×2 gloo mesh of four CPU processes
(``launch.mesh.run_on_mesh``) against the port's one-process step and the
reference's sharded step (its launcher's build on a forced 4-device
``make_host_mesh(2, 2)``, in a subprocess), both packages in float32:
the dense and MoE architectures.

* smollm-360m and mixtral-8x7b at ``reduced()``, vocabulary 512, batch
  8 × 32, two steps in each of ``megatron``, ``zero_seq`` and
  ``zero_batch`` (mixtral with ``moe_groups`` unset, as the reference's
  launcher leaves it: its token group spans the ranks and is gathered);
* mixtral under ``zero_batch`` with ``moe_groups`` 4 and capacity factor 8:
  one group a rank, the expert-parallel all-to-all (``_moe_a2a``) in both
  packages;
* mixtral under ``zero_seq`` with ``moe_groups`` 8, a group a row, as the
  dry run sets it: each model rank dispatches its block of its data rank's
  groups (``layers.seq_groups``; the reference pins the groups over the
  whole mesh);
* internvl2-76b under ``zero_seq`` (the patch embeddings written over the
  global positions that fall in the rank's slice).

Each rank's metrics are the global ones and equal every other rank's;
every rank's parameter, m and v blocks have the shapes their specs give;
the first step's gradients, the losses, grad norms and the parameters
after the second step agree within ``test_torch_lm_mesh_common.TOL``
(measured beside it).  The runs of the file share one mesh spawn and one
reference subprocess (a module fixture), each case its own test.
``tests/test_torch_lm_mesh_parity_seq.py`` holds the recurrent and
encoder-decoder blocks.
"""

from __future__ import annotations

import pytest

from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_lm_mesh_common import MODES, check_job, job, run_jobs

JOBS = {"smollm-360m": ("smollm-360m", MODES, 11, {}),
        "mixtral-8x7b": ("mixtral-8x7b", MODES, 13, {}),
        "mixtral-8x7b-a2a": ("mixtral-8x7b", ("zero_batch",), 15,
                             {"moe_groups": 4, "capacity_factor": 8.0}),
        "mixtral-8x7b-seq": ("mixtral-8x7b", ("zero_seq",), 17,
                             {"moe_groups": 8}),
        "internvl2-76b": ("internvl2-76b", ("zero_seq",), 27, {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = {name: job(arch, modes, seed, **kw)
            for name, (arch, modes, seed, kw) in JOBS.items()}
    ranks, ref = run_jobs(tmp_path_factory.mktemp("lm_mesh"), jobs)
    return jobs, ranks, ref


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_step_matches_one_process_and_reference(name, runs):
    jobs, ranks, ref = runs
    check_job(name, jobs[name], ranks, ref)
