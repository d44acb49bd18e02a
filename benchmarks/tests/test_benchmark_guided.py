"""CPU rehearsals of the high-quality front end's cell, `hq.front25.guided`
(job kind `frontend_hq`), at tiny.py's size: a sound run (and a traced
one) comes out correct, and each planted fault comes out not correct on
its own number, `guided_mismatch_pct`:

- the cell's controls: guided re-matching off (the verified inliers stay),
  the reference's similarities in bfloat16, and the geometry's max_error
  at 16 px (guided band and verification alike);
- faults planted in the program: the epipolar mask at twice max_error, and
  a tenth of the guided matches dropped before the replacement rule.

The limits below are the tests' own, for the `frontend_hq` kind at this
size (CPU runs of the program at tiny.SEED): the sound run reads
off_epipolar_pct 4.98 (guided matches within 4 px of an F estimated at
320x240 reach farther from the true epipolar line than the verified
inliers, 1.42 with guided matching off) and guided_mismatch_pct 0; guided
matching off reads 39.3, the bfloat16 reference 2.46.
"""

import pytest

from benchmarks.tests import tiny

CELL = "hq.front25.guided"
LIMITS = {"off_epipolar_pct": 8.0, "missing": 0.0, "guided_mismatch_pct": 0.5}
tiny.LIMITS.setdefault("frontend_hq", LIMITS)


def _mask_doubled(monkeypatch):
    from colmap_pcd_tpu_torch.ops import matching

    orig = matching.match_guided_u8

    def wide(*args):
        *rest, opts = args
        return orig(*rest, opts._replace(guided_max_error=2 * opts.guided_max_error))

    monkeypatch.setattr(matching, "match_guided_u8", wide)


def _tenth_dropped(monkeypatch):
    import torch

    from colmap_pcd_tpu_torch.ops import matching

    orig = matching.match_guided_u8

    def dropped(*args):
        idx, ok = orig(*args)
        rank = torch.cumsum(ok.long(), -1)
        return idx, ok & (rank % 10 != 0)

    monkeypatch.setattr(matching, "match_guided_u8", dropped)


@pytest.mark.parametrize("trace", [False, True])
def test_sound(trace):
    line = tiny.execute(CELL, trace=trace)
    assert line["correct"], line["check"]
    assert set(line["check"]) == set(LIMITS)
    numbers = line["_judged"]["numbers"]
    assert numbers["guided_mismatch_pct"] == 0.0 and numbers["guided_held"] > 500
    assert numbers["guided_pairs_checked"] >= 10
    counts = line["_record"]["phases"]["counts"]
    assert counts["guided_pairs"] > 0 and counts["guided_kernel_pairs"] == 0 and counts["guided_replaced"] > 0
    if trace:
        assert {"guided.ms_per_pair", "sift.affine_ms_per_image"} <= set(line["metrics"])
        assert "guided.roofline_pct" not in line["metrics"]  # no device time on the CPU


@pytest.mark.parametrize("control", ["guided_off", "reference_bf16", "loose_max_error"])
def test_control(control):
    line = tiny.execute(CELL, control=control)
    value, limit = line["check"]["guided_mismatch_pct"]
    assert not line["correct"] and value > limit, line["check"]


@pytest.mark.parametrize("fault", [_mask_doubled, _tenth_dropped])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = tiny.execute(CELL)
    value, limit = line["check"]["guided_mismatch_pct"]
    assert not line["correct"] and value > limit, line["check"]
