"""The fused sweep's decomposition variants (K8) on the CPU: each mode's plain
version against a numpy transcription of the formulas of
``scripts/kernel_decomposition.py`` (``make_kernel``, lines 49-89), on the
same 32-bit words. The reference's ``nomath`` adds black rows two apart, an
artefact of its 2-row halo tiles; the port adds the rows K1 reads (the row
above, the site's own and the row below, wrapped or zero outside an open
lattice), so the transcription does."""

import numpy as np
import pytest
import torch

from tsu_tpu_torch.ops.checkerboard import split_checkerboard
from tsu_tpu_torch.ops.kernel_decomposition import (
    MODES,
    decomposition_sweep,
    decomposition_sweep_reference,
)
from tsu_tpu_torch.rng import fold_seed, philox_words


def transcription(mode, bits, black, periodic):
    """make_kernel(mode)'s outputs for uint32 words ``bits`` and a black
    plane, in numpy."""
    lo = (bits & 0xFFFF).astype(np.int32)
    hi = (bits >> 16).astype(np.int32)
    if mode in ("prng_only", "prng_grouped"):
        return np.where(lo < 32768, 1.0, -1.0), np.where(hi < 32768, 1.0, -1.0)
    b = black.astype(np.float32)
    pad = b[-1:] if periodic else np.zeros_like(b[:1])
    up = np.concatenate([pad, b[:-1]])
    pad = b[:1] if periodic else np.zeros_like(b[:1])
    down = np.concatenate([b[1:], pad])
    nbr = up + b + down
    red = np.where(lo.astype(np.float32) < nbr * 1000.0 + 32768.0, 1.0, -1.0)
    return red, red


def _black(seed, R, C, dtype):
    lat = np.where(np.random.default_rng(seed).random((R, C)) < 0.5, 1.0, -1.0)
    return split_checkerboard(torch.from_numpy(lat).to(dtype))[1]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_variant_on_injected_words_equals_transcription(mode, periodic, dtype):
    black = _black(1, 18, 20, dtype)
    bits = np.random.default_rng(2).integers(0, 1 << 32, black.shape, dtype=np.uint64)
    U = torch.from_numpy(np.stack([bits & 0xFFFF, bits >> 16]).astype(np.int32))
    red, new_black = decomposition_sweep_reference(mode, black, periodic=periodic, uniforms=U)
    want = transcription(mode, bits, black.float().numpy(), periodic)
    assert red.dtype == new_black.dtype == dtype
    np.testing.assert_array_equal(red.float().numpy(), want[0])
    np.testing.assert_array_equal(new_black.float().numpy(), want[1])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_variant_in_philox_mode_uses_k1s_words(mode):
    """Without injected words a variant draws K1's: the word of site (r, c)
    under (fold_seed(seed), sweep)."""
    black = _black(3, 8, 24, torch.float32)
    bits = philox_words(fold_seed(5), 2, 8, 12).numpy().astype(np.uint64)
    red, new_black = decomposition_sweep(mode, black, seed=5, sweep=2)
    want = transcription(mode, bits, black.numpy(), True)
    np.testing.assert_array_equal(red.numpy(), want[0])
    np.testing.assert_array_equal(new_black.numpy(), want[1])
    assert decomposition_sweep.launches == 0


def test_bad_operands_raise():
    black = _black(4, 8, 8, torch.float32)
    with pytest.raises(ValueError):
        decomposition_sweep("baseline", black)
    with pytest.raises(ValueError):
        decomposition_sweep("nomath", black[:3])
    with pytest.raises(ValueError):
        decomposition_sweep("nomath", black, uniforms=torch.zeros((2, 8, 3), dtype=torch.int32))
