"""The port's parity tool (``dmlc_tpu_torch.tools.parity``) on the CPU.

The [W, N] slot exchange makes a W-process socket-engine world and one
process bit-identical on one device, for any world and either topology:
world 2 over the tree and world 3 over a forced ring must report
``bitexact``. The ``reordered`` kernel (float64 sums, the stand-in for a
second device) must differ in bits and pass ``rtol``. Against the JAX
package's tool on the same default data: the same report fields, the
flags and ulp figures equal; the losses within rtol 1e-6 (XLA's ``log1p``
and torch's differ by a few ulps at margin 0, the first step's loss).
The tool's trackers bind 21500-21599; no other test file uses them.
"""

import numpy as np
import pytest

from dmlc_tpu.tools import parity as ref_parity
from dmlc_tpu_torch.tools import parity
from dmlc_tpu_torch.utils import DMLCError


@pytest.fixture(scope="module")
def world2():
    return parity.run_parity(world=2, steps=3, single_backend="cpu")


def test_ulp_diff_matches_reference():
    a = np.array([1.5, -2.25, 0.0, 3e-9, -1e-45], np.float32)
    b = np.nextafter(a, np.float32(2.0))
    for x, y in ((a, a.copy()), (a, b), (np.float32([-1e-45]),
                                         np.float32([1e-45]))):
        assert parity._ulp_diff(x, y) == ref_parity._ulp_diff(x, y)
    assert parity._ulp_diff(np.float32([1.0]),
                            np.nextafter(np.float32([1.0]), 2)) == 1


def test_world2_tree_bitexact(world2):
    out = world2
    assert out["topology"] == "tree" and out["criterion"] == "bitexact"
    assert out["bitexact"] is True and out["pass"] is True
    assert out["max_grad_ulp"] == 0 and out["max_param_abs_diff"] == 0.0
    assert out["socket_losses"] == out["single_losses"]
    assert out["single_backend"] == "cpu"
    assert out["socket_losses"][-1] < out["socket_losses"][0]


def test_world3_forced_ring_bitexact():
    out = parity.run_parity(world=3, steps=2, force_ring=True,
                            single_backend="cpu")
    assert out["topology"] == "ring"
    assert out["bitexact"] is True and out["max_grad_ulp"] == 0
    assert out["pass"] is True


def test_reordered_kernel_passes_rtol():
    out = parity.run_parity(world=2, steps=2, single_backend="cpu",
                            single_kernel="reordered", criterion="auto")
    assert out["criterion"] == "rtol"  # auto: another kernel, rtol arm
    assert out["bitexact"] is False and out["max_grad_ulp"] > 0
    assert out["max_loss_rel"] <= out["rtol"]
    assert out["pass"] is True


def test_report_matches_reference(world2):
    want = ref_parity.run_parity(world=2, steps=3, single_backend="cpu")
    assert set(want) <= set(world2)
    for k in ("world", "steps", "topology", "socket_backend",
              "single_backend", "single_kernel", "bitexact", "max_grad_ulp",
              "max_param_abs_diff", "rtol", "criterion", "pass"):
        assert world2[k] == want[k], k
    np.testing.assert_allclose(world2["socket_losses"],
                               want["socket_losses"], rtol=1e-6)


def test_default_backend_is_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        parity.run_parity(world=2, steps=1)
    with pytest.raises(SystemExit):
        parity.main(["--single-backend", "tpu"])
