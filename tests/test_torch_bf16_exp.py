"""``vil_tpu``'s default bf16 exponent (BF16_EXP) in the port's bf16
sliding-chunk kernels, on the CPU.

``vil_tpu``'s bf16 sliding-chunk kernels round the exponent's input to bf16
by default (``VIL_TPU_BF16_EXP``, "1": ``vil_kernel.py:71``, ``:388-389``;
``vil_backward.py``'s ``_probs_lse``); until this switch the port's bf16
bodies took the exponent of the f32 difference, which is ``vil_tpu`` under
``VIL_TPU_BF16_EXP=0``. The kernels run only on a card; here their bf16
arithmetic is emulated in f32 (``neighbourhood_attention_bf16`` and its
backward, under either setting) and held to ``vil_tpu``'s Pallas kernels in
interpret mode at their default, in bf16: B1/B2 (``_pallas_forward_mh``,
``vil_attention_backward``) and B5/B6 (``mode_forward``, ``mode_backward``
at mode 3, the sampled chunk up and to the left).

``vil_tpu`` takes its row maximum in bf16 and the port's kernels in f32, so
with a maximum that bf16 does not hold both packages round another
difference and the exponent's rounding hides behind that. The cases give
every row the same exact maximum: a global key of zeros with a bias of 4,
above every local score (q and k at σ 0.35 over head dim 16, the local bias
at σ 0.25). Then the forward under the switch equals ``vil_tpu``'s bit for
bit (measured: out 0, LSE ≤ 1.8e-7 rms), where without it out reads
1.3e-3-2.1e-3 of its rms and the LSE 3.8e-4-4.3e-4; the backward's dq, dk,
dv read 2.6e-3-3.9e-3 of their rms under the switch against 6.9e-3-8.8e-3
without it (dk_glo, dv_glo and dbias, which the exponent's rounding moves
less than the summation's, read alike either way). The tests assert it,
in relative root-mean-square errors, printed: the forward's under the
switch at most ``CLOSER_FWD`` (¼) of the error without it, out ≤ 1e-3 of
its rms and the LSE ≤ 1e-5 rms; the backward's dq, dk, dv at most
``CLOSER_BWD`` (0.6) of their error without it and ≤ 6e-3. Under either
setting the emulation stays within the kernels' existing limit of the f32
plain version (``CHUNK_SCALED_TOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vil_tpu.ops.pallas import vil_backward as jax_vil_backward
from vil_tpu.ops.pallas import vil_kernel as jax_vil_kernel
from vil_tpu.ops.pallas import vil_mode_kernel as jax_mode_kernel
from vil_tpu.ops import sliding_chunk as jax_sc

from vil_tpu_torch.ops import masks
from vil_tpu_torch.ops import sliding_chunk as sc
from vil_tpu_torch.ops.kernels import mask_to_additive
from vil_tpu_torch.ops.kernels.vil_attention import (
    bf16_exp,
    chunk_attention_reference,
    neighbourhood_attention_bf16,
    neighbourhood_attention_bf16_bwd,
)

# the switch's error against vil_tpu at most this share of the error without it
CLOSER_FWD, CLOSER_BWD = 0.25, 0.6
OUT_TOL, LSE_TOL, GRAD_TOL = 1e-3, 1e-5, 6e-3  # under the switch, relative rms (LSE: rms)
CHUNK_SCALED_TOL = 2e-2  # chip_smoke.py's limit of the bf16 kernels against the f32 plain
B, NX, NY, W, H, NGLO, M = 2, 9, 9, 3, 2, 1, 16
MODE = 3  # a sampled neighbour at dx = dy = ±1
KERNELS = {"B1B2": 0, "B5B6": MODE}
# the mode kernels take their mask table as an array operand
_jax_mode_fwd = jax.jit(jax_mode_kernel.mode_forward,
                        static_argnames=("num_heads", "interpret", "with_lse"))
_jax_mode_bwd = jax.jit(jax_mode_kernel.mode_backward,
                        static_argnames=("num_heads", "interpret"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return _rms(ours - ref) / _rms(ref)


def _bf16_values(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _tail(a):
    """Front column order [glo ‖ self ‖ sampled] → vil_tpu's mode tail order."""
    return np.concatenate([a[..., NGLO:], a[..., :NGLO]], axis=-1)


def _front(a):
    return np.concatenate([a[..., a.shape[-1] - NGLO:], a[..., :a.shape[-1] - NGLO]], axis=-1)


@pytest.fixture(scope="module")
def cases():
    """Each pair's inputs (bf16 values), ``vil_tpu``'s bf16 outputs at its
    default BF16_EXP and the pieces the port's emulation takes."""
    assert jax_vil_kernel.BF16_EXP, "vil_tpu's default is on"
    out = {}
    for name, mode in KERNELS.items():
        rng = np.random.default_rng(7 + mode)
        padx, pady, mx, my = sc.chunk_grid(NX, NY, W)
        w2, C, span = W * W, M * H, 9 if mode == 0 else 2
        f = lambda *s: rng.standard_normal(s).astype(np.float32)
        q, k = (_bf16_values(0.35 * f(B, mx, my, w2, C)) for _ in range(2))
        v, g = (_bf16_values(f(B, mx, my, w2, C)) for _ in range(2))
        kg, vg = np.zeros((B, NGLO, C), np.float32), _bf16_values(f(B, NGLO, C))
        bias = 0.25 * f(H, w2, NGLO + span * w2)
        bias[..., :NGLO] = 4.0  # the global key: every row's exact maximum
        mask = mask_to_additive(masks.invalid_mask(mx, my, padx, pady, W, 0, mode),
                                mx, my, w2, NGLO)
        bf = lambda a: jnp.asarray(a, jnp.bfloat16)
        if mode == 0:
            args = (bf(q), bf(k), bf(v), bf(kg), bf(vg), jnp.asarray(bias))
            j_out, j_lse = jax_vil_kernel._pallas_forward_mh(*args, mask, H, interpret=True,
                                                             with_lse=True)
            grads = jax_vil_backward.vil_attention_backward(*args, bf(g), mask, H, lse=j_lse,
                                                            interpret=True)
        else:
            kj, vj = bf(k), bf(v)
            rolled = (bf(q), kj, jax_sc.sampled_roll(kj, mode), vj,
                      jax_sc.sampled_roll(vj, mode))
            tail_mask = jax_mode_kernel.mode_tail_mask(mx, my, padx, pady, W, 0, mode, NGLO)
            args = (*rolled, bf(kg), bf(vg), jnp.asarray(_tail(bias)), tail_mask)
            j_out, j_lse = _jax_mode_fwd(*args, num_heads=H, interpret=True, with_lse=True)
            dq, dks, dknb, dvs, dvnb, dkg, dvg, dbias = _jax_mode_bwd(
                *args, bf(g), num_heads=H, lse=j_lse, interpret=True)
            sx, sy = (int(s) for s in sc.MODE_ROLL_SHIFTS[mode])
            unroll = lambda t: jnp.roll(t.astype(jnp.float32), (-sx, -sy), axis=(1, 2))
            grads = (dq, dks.astype(jnp.float32) + unroll(dknb),
                     dvs.astype(jnp.float32) + unroll(dvnb), dkg, dvg,
                     _front(np.asarray(dbias)))
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        out[name] = dict(
            ops=[t(a).to(torch.bfloat16) for a in (q, k, v, kg, vg)], bias=t(bias),
            mask=t(mask), g=t(g).to(torch.bfloat16), mode=mode,
            j_out=np.asarray(j_out, np.float32), j_lse=np.asarray(j_lse),
            j_grads=[np.asarray(a, np.float32) for a in grads])
    return out


def _neighbours(mode):
    return lambda t: sc.neighborhood(t, mode)


@pytest.mark.parametrize("name", list(KERNELS))
def test_forward_with_the_switch_reads_vil_tpu(cases, name):
    """B1 / B5: out and LSE of the emulation under either setting against
    ``vil_tpu``'s at its default."""
    c = cases[name]
    errs = {}
    for on in (True, False):
        out, lse = neighbourhood_attention_bf16(*c["ops"], c["bias"], c["mask"], H,
                                                _neighbours(c["mode"]), on, with_lse=True)
        errs[on] = (_rel(out.float(), c["j_out"]), _rms(lse.numpy() - c["j_lse"]))
    print(f"{name} forward, relative rms of out / rms of the LSE against vil_tpu: "
          f"with the switch {errs[True]}, without {errs[False]}")
    assert errs[True][0] <= OUT_TOL and errs[True][1] <= LSE_TOL, errs
    assert errs[True][0] <= CLOSER_FWD * errs[False][0], errs
    assert errs[True][1] <= CLOSER_FWD * errs[False][1], errs


@pytest.mark.parametrize("name", list(KERNELS))
def test_backward_with_the_switch_reads_vil_tpu(cases, name):
    """B2 / B6: dq, dk, dv of the emulation from ``vil_tpu``'s own out and
    LSE, under either setting, against ``vil_tpu``'s backward at its
    default; dk_glo, dv_glo and dbias are printed (dk_glo sums the unrounded
    dS, as the kernels' global columns do, where ``vil_tpu`` rounds it)."""
    c = cases[name]
    out = torch.from_numpy(c["j_out"]).to(torch.bfloat16)
    lse = torch.from_numpy(c["j_lse"])
    errs = {}
    for on in (True, False):
        grads = neighbourhood_attention_bf16_bwd(
            *c["ops"], c["bias"], c["g"], out, lse, c["mask"], H, _neighbours(c["mode"]), on)
        errs[on] = [_rel(a.float(), b) for a, b in zip(grads, c["j_grads"])]
    print(f"{name} backward, relative rms of dq, dk, dv, dk_glo, dv_glo, dbias against "
          f"vil_tpu: with the switch {errs[True]}, without {errs[False]}")
    for i, grad in enumerate(("dq", "dk", "dv")):
        assert errs[True][i] <= GRAD_TOL, (grad, errs)
        assert errs[True][i] <= CLOSER_BWD * errs[False][i], (grad, errs)


@pytest.mark.parametrize("name", list(KERNELS))
def test_emulation_stays_within_the_kernels_limit(cases, name):
    """Under either setting the emulated forward keeps to the bf16 kernels'
    limit against the f32 plain version: max|err| / max|ref| of out."""
    c = cases[name]
    ref = chunk_attention_reference(*[t.float() for t in c["ops"]], c["bias"], c["mask"], H,
                                    c["mode"])
    for on in (True, False):
        out = neighbourhood_attention_bf16(*c["ops"], c["bias"], c["mask"], H,
                                           _neighbours(c["mode"]), on)
        err = (out.float() - ref).abs().max() / ref.abs().max()
        assert err <= CHUNK_SCALED_TOL, (on, float(err))


def test_the_switch_is_on_by_default_and_read_at_each_call(monkeypatch):
    monkeypatch.delenv("VIL_TPU_BF16_EXP", raising=False)
    assert bf16_exp()
    monkeypatch.setenv("VIL_TPU_BF16_EXP", "0")
    assert not bf16_exp()
    monkeypatch.setenv("VIL_TPU_BF16_EXP", "1")
    assert bf16_exp()
