"""On the card: the reference's DFT in float32 agrees with cuFFT with TF32
off even where the process turned it on, and the control's TF32 rounding
is visibly less precise there too.  Skips without a card (the benchmark's
cells themselves run by ``benchmark/run.py``)."""

import pytest
import torch

from benchmark.reference import ptycho


@pytest.mark.cuda
def test_control_precision_engages_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    g = torch.Generator(device='cuda').manual_seed(5)
    x = torch.complex(torch.randn(64, 72, 72, generator=g, device='cuda'),
                      torch.randn(64, 72, 72, generator=g, device='cuda'))
    want = torch.fft.fft2(x)
    errs = {}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for prec in ('f32', 'tf32'):
            tr = ptycho.Transforms(72, 72, 1.0, 0.248, 8.0, 'cuda', prec)
            with tr.tf32_off():
                errs[prec] = float(((tr.dft2(x) - want).abs().max()
                                    / want.abs().max()))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert errs['f32'] < 1e-5
    assert errs['tf32'] > 10 * errs['f32']
