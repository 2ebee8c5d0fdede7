"""PyTorch port vs libstacker_tpu: the ECC align+stack slice end to end.

``libstacker_tpu_torch.ecc_match_arrays`` (plain CPU path,
``device="cpu"``) against ``libstacker_tpu.ecc_match_arrays`` on the same
numpy burst with the headline parameters (Homography, max_count 50, eps
1e-4, gauss 5, coarse_levels 1, phase start on): equal ``ok`` flags and
stacked interiors within 0.02 (tests/test_pipeline_ecc.py:73-74).  Also
the scaled path, the 1-frame path, the guards' error types and messages,
``on_failure``, ``ecc_match`` on files, ``output_scale``, ``solver`` and
``phase_init_rotation``, ``mesh="auto"`` (once refused), and the copied
host modules pinned to the originals.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

import libstacker_tpu as J  # noqa: E402
from libstacker_tpu import constants as jconstants  # noqa: E402
from libstacker_tpu import errors as jerrors  # noqa: E402
from libstacker_tpu import params as jparams  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import burst, n, t  # noqa: E402
from libstacker_tpu_torch import constants, errors, params  # noqa: E402
from libstacker_tpu_torch.utils import interop  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(mod, **kw):
    base = dict(motion_type=mod.MotionType.Homography, max_count=50,
                epsilon=1e-4, gauss_filt_size=5, coarse_levels=1)
    base.update(kw)
    return mod.EccMatchParameters(**base)


@pytest.fixture(scope="module")
def frames():
    return burst(21, 4, 192, 256, max_shift=4.0, max_angle=0.4)[0]


@pytest.fixture(scope="module")
def jax_headline(frames):
    return J.ecc_match_arrays(frames, _params(J), return_stats=True)


def test_slice_matches_jax(frames, jax_headline):
    got, st = P.ecc_match_arrays(frames, _params(P), return_stats=True,
                                 device="cpu")
    want, jst = jax_headline
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == frames.shape[1:]
    assert st.frames_kept == jst.frames_kept == 4
    np.testing.assert_allclose(st.ecc_rho, jst.ecc_rho, atol=1e-3)
    d = np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8])
    assert d.max() < 0.02, d.max()
    assert set(st.phase_ms) == {"grey", "phase init", "ecc octave build",
                                "ecc octave solve", "ecc full-res solve",
                                "stack"}


def test_tensor_input_and_device_output(frames, jax_headline):
    """A tensor burst runs on its own device; device_output keeps the
    result a tensor there; stats and output agree with the numpy call."""
    out = P.ecc_match_arrays(t(frames), _params(P), device_output=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    want, _ = jax_headline
    d = np.abs(n(out)[8:-8, 8:-8] - want[8:-8, 8:-8])
    assert d.max() < 0.02


def test_default_device_needs_cuda(frames, monkeypatch):
    """device defaults to "cuda": without a card the call raises instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        P.ecc_match_arrays(frames, _params(P))


def test_scaled_path_matches_jax(frames):
    """Solve on INTER_AREA-scaled greys, stack at full size with the
    rescaled warps (Translation, and the homography's perspective row)."""
    for motion, sdw in (("Translation", 128.0), ("Homography", 150.0)):
        pj = _params(J, motion_type=J.MotionType[motion], coarse_levels=0)
        pp = _params(P, motion_type=P.MotionType[motion], coarse_levels=0)
        want = J.ecc_match_arrays(frames, pj, scale_down_width=sdw)
        got = P.ecc_match_arrays(frames, pp, scale_down_width=sdw,
                                 device="cpu")
        d = np.abs(got[10:-10, 10:-10] - want[10:-10, 10:-10])
        assert d.max() < 0.02, (motion, d.max())


def test_single_frame(frames):
    one = frames[:1]
    got = P.ecc_match_arrays(one, _params(P), device="cpu")
    np.testing.assert_array_equal(got, J.ecc_match_arrays(one, _params(J)))
    np.testing.assert_allclose(got, one[0].astype(np.float32) / 255.0,
                               atol=1e-7)
    _, st = P.ecc_match_arrays(one, _params(P), return_stats=True,
                               device="cpu")
    assert (st.frames_total, st.frames_kept, st.frames_dropped) == (1, 1, 0)


@pytest.mark.parametrize("case", ["wide", "narrow", "empty", "ndim", "dtype"])
def test_guards_match_jax(frames, case):
    sdw = None
    arr = frames
    if case == "wide":
        sdw = 256.0
    elif case == "narrow":
        sdw = 10.0
    elif case == "empty":
        arr = frames[:0]
    elif case == "ndim":
        arr = frames[..., 0]
    else:
        arr = frames.astype(np.float32)
    with pytest.raises(jerrors.StackerError) as want:
        J.ecc_match_arrays(arr, _params(J), scale_down_width=sdw)
    with pytest.raises(errors.StackerError) as got:
        P.ecc_match_arrays(arr, _params(P), scale_down_width=sdw,
                           device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_on_failure_drop_and_raise(frames):
    """A flat frame has no correlation: it fails in both packages;
    "drop" leaves it out of the sum and divides by the kept count,
    "raise" names it."""
    bad = frames.copy()
    bad[2] = 128
    kw = dict(coarse_levels=0)
    want = J.ecc_match_arrays(bad, _params(J, **kw), on_failure="drop")
    got, st = P.ecc_match_arrays(bad, _params(P, **kw), on_failure="drop",
                                 return_stats=True, device="cpu")
    assert (st.frames_kept, st.frames_dropped) == (3, 1)
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
    with pytest.raises(jerrors.ProcessingError) as je:
        J.ecc_match_arrays(bad, _params(J, **kw))
    with pytest.raises(errors.ProcessingError) as pe:
        P.ecc_match_arrays(bad, _params(P, **kw), device="cpu")
    assert str(pe.value) == str(je.value)


def test_ecc_match_files(frames, tmp_path, jax_headline):
    from PIL import Image

    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"f{i}.png")
    got = P.ecc_match(str(tmp_path), _params(P), device="cpu")
    np.testing.assert_array_equal(
        got, P.ecc_match_arrays(frames, _params(P), device="cpu"))
    want, _ = jax_headline
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
    from libstacker_tpu_torch.utils import io as pio

    assert len(pio.collect_image_files(tmp_path)) == 4
    with pytest.raises(errors.NotEnoughFilesError):
        P.ecc_match([], _params(P), device="cpu")


@pytest.mark.parametrize("opt,item", [
    (dict(mesh="auto"), "item 16"),
])
def test_unported_options_raise(frames, opt, item):
    """The option this package once refused (ROADMAP.md ``item``), now
    ported: ``mesh="auto"`` with ``device="cpu"`` is a one-shard CPU mesh
    and equals the dense path bitwise, with the same stats."""
    want, wst = P.ecc_match_arrays(frames, _params(P), device="cpu",
                                   return_stats=True)
    got, st = P.ecc_match_arrays(frames, _params(P), device="cpu",
                                 return_stats=True, **opt)
    np.testing.assert_array_equal(got, want)
    assert st.frames_kept == wst.frames_kept == 4, item
    assert st.ecc_iterations == wst.ecc_iterations


@pytest.mark.parametrize("opt", [
    dict(output_scale=2), dict(solver="lazy"), dict(solver="ic"),
    dict(phase_init_rotation=True),
])
def test_lifted_options_match_jax(frames, opt):
    """The options this package once refused, with the headline
    parameters, against the JAX package with the same options (which
    solves 'lazy' and 'ic' forward on the CPU): same kept frames, rho
    within 1e-3, stacked interior within 0.02."""
    want, jst = J.ecc_match_arrays(frames, _params(J, **opt),
                                   return_stats=True)
    got, st = P.ecc_match_arrays(frames, _params(P, **opt),
                                 return_stats=True, device="cpu")
    f = opt.get("output_scale", 1)
    assert got.shape == want.shape == (f * 192, f * 256, 3)
    assert st.frames_kept == jst.frames_kept == 4
    np.testing.assert_allclose(st.ecc_rho, jst.ecc_rho, atol=1e-3)
    c = 8 * f
    assert np.abs(got[c:-c, c:-c] - want[c:-c, c:-c]).max() < 0.02


def test_unported_entry_points_raise(tmp_path):
    """The entry points once refused: ``mesh=`` (item 16), the stream
    included, ``preserve_depth`` (item 14a) and the stream (item 14b) are
    ported and raise the reference's errors: a stream over
    ``mesh="auto"`` gets as far as decoding its missing file."""
    with pytest.raises(errors.NotEnoughFilesError):
        P.ecc_match([], _params(P), preserve_depth=True, device="cpu")
    with pytest.raises(errors.NotEnoughFilesError):
        P.ecc_match_stream([], _params(P), device="cpu")
    with pytest.raises(errors.StackerIoError):
        P.ecc_match_stream([tmp_path / "a.png"], _params(P), mesh="auto",
                           device="cpu")


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_copied_modules_pinned_to_originals():
    """params.py, errors.py and constants.py of the port are copies:
    same dataclass fields and defaults, same validate() messages, same
    constants and error texts."""
    for name in ("EccMatchParameters", "KeyPointMatchParameters"):
        assert _fields(getattr(params, name)) == \
            _fields(getattr(jparams, name))
    assert {m.name: int(m) for m in params.MotionType} == \
        {m.name: int(m) for m in jparams.MotionType}
    bad_ecc = [dict(gauss_filt_size=4), dict(max_count=0),
               dict(coarse_levels=9), dict(solver="x"),
               dict(stacking="median"), dict(output_scale=5),
               dict(stacking="sigma_clip", sigma_kappa=0.0),
               dict(stacking="sigma_clip", sigma_iters=0),
               dict(output_scale=2, stacking="sigma_clip")]
    for kw in bad_ecc:
        with pytest.raises(jerrors.InvalidParamsError) as je:
            jparams.EccMatchParameters(jparams.MotionType.Affine, **kw).validate()
        with pytest.raises(errors.InvalidParamsError) as pe:
            params.EccMatchParameters(params.MotionType.Affine, **kw).validate()
        assert str(pe.value) == str(je.value)
    with pytest.raises(errors.InvalidParamsError) as pe:
        params.EccMatchParameters(3).validate()
    with pytest.raises(jerrors.InvalidParamsError) as je:
        jparams.EccMatchParameters(3).validate()
    assert str(pe.value) == str(je.value)
    for kw in (dict(method=1), dict(match_ratio=0.0), dict(max_iters=0),
               dict(confidence=1.0), dict(match_keep_ratio=0.0)):
        with pytest.raises(jerrors.InvalidParamsError) as je:
            jparams.KeyPointMatchParameters(**kw).validate()
        with pytest.raises(errors.InvalidParamsError) as pe:
            params.KeyPointMatchParameters(**kw).validate()
        assert str(pe.value) == str(je.value)
    assert params.EccMatchParameters(params.MotionType.Affine,
                                     max_count=7).resolve_criteria() == \
        jparams.EccMatchParameters(jparams.MotionType.Affine,
                                   max_count=7).resolve_criteria()
    pub = {k: v for k, v in vars(constants).items() if k.isupper()}
    assert pub == {k: v for k, v in vars(jconstants).items() if k.isupper()}
    assert constants.border_mode_name(4) == jconstants.border_mode_name(4)
    for cls in ("NotEnoughFilesError", "InvalidParamsError",
                "ProcessingError"):
        args = () if cls == "NotEnoughFilesError" else ("x",)
        assert str(getattr(errors, cls)(*args)) == \
            str(getattr(jerrors, cls)(*args))
    assert issubclass(errors.StackerIoError, errors.StackerError)


def test_port_imports_no_jax():
    code = ("import sys, libstacker_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'libstacker_tpu.'))]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_interop_round_trip(frames):
    pj = _params(J, epsilon=2e-4)
    pp = interop.params_from_reference(dataclasses.asdict(pj))
    assert pp == _params(P, epsilon=2e-4)
    w = np.eye(3, dtype=np.float32)[None]
    tw = interop.to_tensor(w)
    assert tw.dtype == torch.float32 and tw.shape == (1, 3, 3)
    np.testing.assert_array_equal(interop.to_numpy(tw), w)
    from libstacker_tpu_torch.ops import ecc

    grey = frames[..., 0].astype(np.float32)
    res = ecc.find_transform_ecc_batched(
        t(grey[1:2]), t(grey[0]), P.MotionType.Translation, 5, 1e-4)
    d = interop.result_to_numpy(res)
    assert set(d) == {"rho", "warp_matrix", "ok", "num_iters"}
    assert d["warp_matrix"].shape == (1, 2, 3)
