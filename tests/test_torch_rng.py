"""Philox4x32-10 streams of the PyTorch port (montecarlo_risk_engine_tpu_torch/rng.py)."""

import numpy as np
import pytest
import torch

from montecarlo_risk_engine_tpu_torch import rng

torch.set_num_threads(1)

# Random123 known-answer vectors for philox4x32-10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", KAT)
def test_philox_known_answers(counter, key, expected):
    words = rng.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(w) for w in words) == expected


def test_mulhilo_matches_python_integers():
    rs = np.random.default_rng(3)
    b = rs.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.int64)
    b[:2] = (0, 0xFFFFFFFF)
    for a in (0xD2511F53, 0xCD9E8D57, 0xFFFFFFFF):
        hi, lo = rng._mulhilo(a, torch.from_numpy(b))
        full = [a * int(x) for x in b]
        assert hi.tolist() == [p >> 32 for p in full]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in full]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniforms_strictly_inside_unit_interval(dtype):
    edge = torch.tensor([0, 0xFF, 0x100, 0xFFFFFF00, 0xFFFFFFFF], dtype=torch.int64)
    u = rng.uniform_from_word(edge, dtype)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    _, _, u_all = rng.substep_draws(7, rng.PHASE_MAINSIM, 3, 1 << 16, dtype, "cpu")
    assert float(u_all.min()) > 0.0 and float(u_all.max()) < 1.0
    assert abs(float(u_all.mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / 256


def test_presim_and_mainsim_words_differ():
    paths = torch.arange(4096, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64)
    for counter in (0, 1, 39):
        step = torch.tensor(counter, dtype=torch.int64)
        pre = rng.philox4x32_10((paths, step, zero, zero), (0, rng.PHASE_PRESIM))
        main = rng.philox4x32_10((paths, step, zero, zero), (0, rng.PHASE_MAINSIM))
        for wp, wm in zip(pre, main):
            assert not torch.equal(wp, wm)
            assert len(set(wp.tolist()) & set(wm.tolist())) < 4


def test_draws_are_pure_in_path_index():
    # A path's draws do not depend on how many paths the run has.
    full = rng.substep_draws(5, rng.PHASE_MAINSIM, 11, 1000, torch.float64, "cpu")
    head = rng.substep_draws(5, rng.PHASE_MAINSIM, 11, 300, torch.float64, "cpu")
    for f, s in zip(full, head):
        assert torch.equal(f[:300], s)


def test_box_muller_moments():
    z_s, z_v, _ = rng.substep_draws(1, rng.PHASE_MAINSIM, 0, 1 << 17, torch.float64, "cpu")
    z = torch.stack([z_s, z_v])
    se = (1.0 / (1 << 17)) ** 0.5
    assert torch.all(z.mean(dim=1).abs() < 5 * se)
    assert torch.all((z.var(dim=1) - 1.0).abs() < 5 * 2 ** 0.5 * se)
    assert abs(float((z_s * z_v).mean())) < 5 * se
