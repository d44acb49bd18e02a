"""The root finder's kernel route seen from the CPU: CPU tensors take the
plain route (`polynomial.real_roots_plain`) and neither build nor launch
the hand kernel (ops/roots_kernel.py, csrc/poly_roots.cu); PHASES counts
every polynomial rooted in `roots_polys` and those the kernel rooted in
`roots_kernel_polys` (0 here), from the solvers and from a verification
block; the kernel's wrapper refuses what it does not take before it builds
anything. The kernel itself is held against the plain route on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from colmap_pcd_tpu_torch.ops import cuda_build, polynomial, roots_kernel, solvers
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

import roots_banks

torch.set_num_threads(1)  # the suite runs several workers on few cores

COUNTERS = ("roots_polys", "roots_kernel_polys")


def _kernel_state():
    """What a launch or a build would change: the launch count, the loaded
    library, the sources this process compiled."""
    return roots_kernel.real_roots_cuda.launches, roots_kernel._lib, dict(cuda_build.BUILD_SECONDS)


def _counts():
    return {k: PHASES.counts.get(k, 0) for k in COUNTERS}


def _delta(before):
    return {k: PHASES.counts.get(k, 0) - before[k] for k in COUNTERS}


@pytest.mark.parametrize("deg", [1, 2, 4, 7, 10])
def test_cpu_roots_take_the_plain_route(deg):
    rng = np.random.default_rng(deg)
    coeffs = torch.as_tensor(np.concatenate([roots_banks.random_bank(rng, deg, 40), roots_banks.hard_bank(deg)]))
    state, before = _kernel_state(), _counts()
    roots, valid = polynomial.real_roots(coeffs)
    assert _kernel_state() == state
    assert _delta(before) == {"roots_polys": coeffs.shape[0], "roots_kernel_polys": 0}
    assert "roots_kernel_polys" in PHASES.counts
    plain = polynomial.real_roots_plain(coeffs)
    assert torch.equal(roots, plain[0]) and torch.equal(valid, plain[1])
    assert roots.dtype == torch.float32 and valid.dtype == torch.bool and roots.shape == (coeffs.shape[0], deg)
    # the vanishing leading coefficient has no roots; the double root 1.5 is found
    assert not valid[-5 if deg >= 2 else -4].any()
    double = roots[-4 if deg >= 2 else -3][valid[-4 if deg >= 2 else -3]]
    assert int((torch.abs(double - 1.5) < 5e-3).sum()) == min(deg, 2)


def test_roots_counters_count_every_polynomial_of_a_batch():
    """A batch [3, 7] of quartics is 21 polynomials."""
    coeffs = torch.as_tensor(roots_banks.random_bank(np.random.default_rng(0), 4, 21)).reshape(3, 7, 5)
    before = _counts()
    roots, valid = polynomial.real_roots(coeffs)
    assert roots.shape == valid.shape == (3, 7, 4)
    assert _delta(before) == {"roots_polys": 21, "roots_kernel_polys": 0}


def test_solvers_count_their_banks_on_the_cpu():
    """five_point roots one degree-10 polynomial a sample, p3p one quartic
    a sample; none on the kernel here."""
    uv, X = roots_banks.p3p_samples(1, S=6)
    state, before = _kernel_state(), _counts()
    solvers.p3p(uv, X)
    assert _delta(before) == {"roots_polys": 6, "roots_kernel_polys": 0}
    rng = np.random.default_rng(2)
    x1 = torch.as_tensor(rng.normal(0, 0.3, (4, 5, 2)).astype(np.float32))
    x2 = torch.as_tensor(rng.normal(0, 0.3, (4, 5, 2)).astype(np.float32))
    before = _counts()
    solvers.five_point(x1, x2)
    assert _delta(before) == {"roots_polys": 4, "roots_kernel_polys": 0}
    assert _kernel_state() == state


def test_verification_block_on_the_cpu_roots_its_e_bank_on_the_plain_route():
    """Two corridor pairs through two_view_verify_dispatch on the CPU: the
    E bank roots 2 048 // 10 polynomials a pair, none on the kernel."""
    from colmap_pcd_tpu_torch.models import two_view

    items = roots_banks.verification_items(7, B=2, n=300)
    state, before = _kernel_state(), _counts()
    outputs, ctx = two_view.two_view_verify_dispatch(items, two_view.TwoViewOptions(), device="cpu")
    assert _delta(before) == {"roots_polys": 2 * (2048 // 10), "roots_kernel_polys": 0}
    assert _kernel_state() == state
    fetched = two_view.fetch(outputs)
    assert (fetched["config"] == two_view.CALIBRATED).all() and (fetched["n_best"] > 0.7 * 300).all()


@pytest.mark.parametrize("case", ["cpu", "degree 11", "degree 0", "float64", "scalar"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """Each refusal is a ValueError raised before the kernel is built."""
    c = torch.ones(8, 5)
    bad = {
        "cpu": c,
        "degree 11": torch.ones(8, 12),
        "degree 0": torch.ones(8, 1),
        "float64": c.double(),
        "scalar": torch.ones(()),
    }[case]
    state = _kernel_state()
    with pytest.raises(ValueError, match="real_roots_cuda"):
        roots_kernel.real_roots_cuda(bad)
    assert _kernel_state() == state
