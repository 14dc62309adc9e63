"""PyTorch port on the card: each CUDA kernel against its plain version, the
launch counters, the wrappers' input checks, and a small encoder through
both kernels against the dense path.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card and
skips without one.  On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the parity tests,
and these tests import nothing of JAX.)

Tolerance: atol 1e-4, rtol 1e-4 for a kernel against its plain version
(fp32, another summation order and ``expf`` against ``torch.softmax``).
"""

import pytest
import torch

from transformer_transducer_tpu_torch.models.attention import slice_pos_table
from transformer_transducer_tpu_torch.models.transducer import build_transducer
from transformer_transducer_tpu_torch.ops.cuda.banded_attention import (
    banded_attention, banded_attention_plain)
from transformer_transducer_tpu_torch.ops.cuda.flash_rel_attention import (
    flash_rel_attention, flash_rel_attention_plain)
from transformer_transducer_tpu_torch.ops.masks import context_mask
from transformer_transducer_tpu_torch.utils.config import Config
from transformer_transducer_tpu_torch.utils.convert import (
    from_jax_params, random_jax_params)

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-4, rtol=1e-4)
B, H, DH, K_LEN = 2, 4, 64, 150


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, tlen, dh=DH):
    """q, k, v as strided views of one fused projection, as the model hands
    them over; tables of ``K_LEN`` rows sliced (or front-padded) to T."""
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda") * 0.5
    q, k, v = mk(B, tlen, 3, H, dh).unbind(2)
    return (q, k, v, slice_pos_table(mk(K_LEN, H, dh), tlen), mk(H, dh),
            slice_pos_table(mk(K_LEN, H), tlen))


# T around the kernels' 32-row query tile and 64-key chunk; 200 > K_LEN
@pytest.mark.parametrize("tlen", [1, 2, 31, 32, 33, 97, 200])
@pytest.mark.parametrize("left,right", [(10, 2), (0, 0), (64, 64), (3, 64), (64, 0)])
def test_banded_kernel_matches_plain(gen, tlen, left, right):
    args = _inputs(gen, tlen)
    before = banded_attention.launches
    got = banded_attention(*args, left, right)
    torch.cuda.synchronize()
    assert banded_attention.launches == before + 1
    torch.testing.assert_close(got, banded_attention_plain(*args, left, right), **TOL)


@pytest.mark.parametrize("tlen", [1, 2, 33, 64, 65, 200])
def test_flash_kernel_matches_plain(gen, tlen):
    args = _inputs(gen, tlen)
    before = flash_rel_attention.launches
    got = flash_rel_attention(*args)
    torch.cuda.synchronize()
    assert flash_rel_attention.launches == before + 1
    torch.testing.assert_close(got, flash_rel_attention_plain(*args), **TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q, k, v, re, u, rb = _inputs(gen, 40)
    with pytest.raises(ValueError, match="Dh == 64"):
        flash_rel_attention(*_inputs(gen, 40, dh=32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_rel_attention(q, k, v, re.transpose(1, 2).contiguous().transpose(1, 2),
                            u, rb)
    with pytest.raises(ValueError, match="is on cpu"):
        banded_attention(q, k, v, re, u.cpu(), rb, 10, 2)
    with pytest.raises(ValueError, match="outside"):
        banded_attention(q, k, v, re, u, rb, 10, 65)


def test_encoder_through_the_kernels_matches_the_dense_path(gen):
    """Two layers at head width 64: ``encode_banded`` (banded kernel) against
    ``encode`` under ``context_mask`` (dense), and a ``flash=True`` model's
    full-context encode (flash kernel) against the dense unmasked one."""
    layer = {"n_layer": 2, "n_head": 2, "d_model": 128, "d_head": DH,
             "d_inner": 256}
    cfg = Config({"enc": dict(layer, max_input_length=K_LEN),
                  "dec": dict(layer, max_target_length=42),
                  "joint": {"inner_size": 96}, "vocab_size": 40})
    state = from_jax_params(random_jax_params(cfg, seed=1))
    dense, fused = (build_transducer(cfg, flash=f, device="cuda") for f in (False, True))
    dense.load_state_dict(state)
    fused.load_state_dict(state)
    x = torch.randn(B, 70, 128, generator=gen, device="cuda")
    with torch.no_grad():
        banded = dense.encode_banded(x, 10, 2)
        masked = dense.encode(x, context_mask(70, 10, 2, device="cuda"))
        flash = fused.encode(x)
        full = dense.encode(x)
    torch.testing.assert_close(banded, masked, **TOL)
    torch.testing.assert_close(flash, full, **TOL)
