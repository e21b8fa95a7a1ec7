"""PyTorch port vs JAX reference: ``benchmarks.run_benchmarks`` (the
reference's solve benchmarks) on the CPU.

``run_benchmarks(["simple_collision", "planning"], batch=2, repeats=1,
device="cpu")`` against the reference's own ``run_benchmarks`` with the
same arguments (float32, as its ``_BENCHES`` builds them): the same
entries in order, the same keys, and equal ``converged`` and
``mean_qp_solves``.  (The scenes' data and float64 solves are
``test_torch_scenes.py``'s and ``test_torch_rail.py``'s.)
"""

import pytest
import torch

from trajopt_tpu import benchmarks as JB
from trajopt_tpu_torch import benchmarks as TB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU solves are many small ops, where torch's intra-op
    threads only add overhead (the rail at T=12: 21.4 s of wall and 107 s
    of CPU with 8 threads, 13.9 s and 13.9 s with one), and the test run
    shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_benchmarks_matches_reference():
    names = ["simple_collision", "planning"]
    ref = JB.run_benchmarks(names=names, batch=2, repeats=1)
    got = TB.run_benchmarks(names=names, batch=2, repeats=1, device="cpu")
    assert [r["name"] for r in got] == names
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert g["batch"] == r["batch"] == 2
        assert g["converged"] == r["converged"]
        assert g["mean_qp_solves"] == r["mean_qp_solves"]
