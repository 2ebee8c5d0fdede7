"""The port's example workflow, ``python -m libstacker_tpu_torch.stack_burst``
(``examples/stack_burst.py``'s counterpart, ROADMAP.md Queue A item 18),
driven in process with ``--device cpu`` on a tiny burst with one blurred
frame: the blurred frame is ranked worst and dropped, the ranking equals
the JAX package's ``sharpness_all`` order on the same frames, the PNGs
are written whole-burst and streamed (mean and sigma-clip), and
``--mesh auto`` writes what the run without ``--mesh`` writes, while
``--mesh N`` above the visible devices exits with the JAX package's
message."""

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
jnp = pytest.importorskip("jax.numpy")

from libstacker_tpu.ops import color as jcolor  # noqa: E402
from libstacker_tpu.ops import sharpness as jsharp  # noqa: E402

from libstacker_tpu_torch import stack_burst  # noqa: E402
from libstacker_tpu_torch.utils import io as pio  # noqa: E402

torch.set_num_threads(2)

ECC_FAST = ["--max-count", "30", "--epsilon", "1e-3",
            "--motion-type", "translation"]


@pytest.fixture(scope="module")
def tiny_burst(tmp_path_factory):
    """5 frames of 120x160 shifted by up to 2 px; frame 2 blurred
    (``tests/test_example_cli.py``'s burst, one frame more)."""
    rng = np.random.default_rng(2024)
    h, w = 120, 160
    small = rng.integers(0, 256, size=(h // 8, w // 8), dtype=np.uint8)
    base = cv2.resize(small, (w * 2, h * 2), interpolation=cv2.INTER_NEAREST)
    base = cv2.GaussianBlur(base, (3, 3), 0.8)
    d = tmp_path_factory.mktemp("burst")
    for i in range(5):
        dx, dy = rng.uniform(-2, 2, 2) if i else (0.0, 0.0)
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        crop = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        if i == 2:
            crop = cv2.GaussianBlur(crop, (0, 0), 2.5)
        Image.fromarray(np.stack([crop] * 3, -1)).save(d / f"frame{i}.png")
    return d


def _table(text):
    lines = text.splitlines()
    start = lines.index("Files ordered by TENG (low quality first)") + 1
    return [ln.split()[0] for ln in lines[start : start + 5]]


def test_ranking_matches_jax_and_drops_the_blurred_frame(tiny_burst, tmp_path,
                                                         capsys):
    out = tmp_path / "out"
    rc = stack_burst.main(
        [str(tiny_burst), "--out", str(out), "--device", "cpu", "--method",
         "ecc", "--no-scaled"] + ECC_FAST)
    assert rc == 0
    text = capsys.readouterr().out
    ranked = _table(text)
    assert ranked[0].endswith("frame2.png")
    files = pio.collect_image_files(tiny_burst)
    frames = pio.load_frames(files)
    want = jsharp.sharpness_all(jcolor.rgb_to_gray_u8(jnp.asarray(frames)))
    order = np.argsort(np.asarray(want["teng"]), kind="stable")
    assert ranked == [str(files[i]) for i in order]
    # the worst frame is dropped and the sharpest is the reference
    assert f"stacking 4 frames; reference = {files[order[-1]]}" in text
    img = np.asarray(Image.open(out / "ecc_full.png"))
    assert img.shape == (120, 160, 3)


@pytest.mark.parametrize("extra,names", [
    ([], ("keypoint_full", "keypoint_w64", "ecc_full", "ecc_w64")),
    (["--stream", "2"], ("keypoint_full", "ecc_full")),
    (["--stream", "2", "--stacking", "sigma_clip"],
     ("keypoint_full", "ecc_full")),
])
def test_writes_every_variant(tiny_burst, tmp_path, capsys, extra, names):
    out = tmp_path / "out"
    args = [str(tiny_burst), "--out", str(out), "--device", "cpu",
            "--scale-width", "64", "--match-ratio", "0.95"] + ECC_FAST + extra
    if extra:
        args.append("--no-scaled")
    assert stack_burst.main(args) == 0
    text = capsys.readouterr().out
    for name in names:
        img = np.asarray(Image.open(out / f"{name}.png"))
        assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    assert sorted(p.stem for p in out.iterdir()) == sorted(names)
    assert "dropped" in text and "stacked images written to" in text
    if not extra:
        assert "keypoint_match(full) dropped frames: 0" in text


def test_refusals(tiny_burst, tmp_path, capsys, monkeypatch):
    # one CPU device is visible with --device cpu (examples/stack_burst.py
    # :178-186 prints this and returns 1)
    assert stack_burst.main([str(tiny_burst), "--mesh", "2", "--device",
                             "cpu"]) == 1
    assert "--mesh 2 exceeds the 1 visible devices" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        stack_burst.main([str(tiny_burst), "--stream", "2",
                          "--output-scale", "2", "--device", "cpu"])
    empty = tmp_path / "empty"
    empty.mkdir()
    assert stack_burst.main([str(empty), "--device", "cpu"]) == 1
    # the default device is the card: without one that raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        stack_burst.main([str(tiny_burst), "--out", str(tmp_path / "o")])


@pytest.mark.parametrize("extra", [[], ["--stream", "2"]])
def test_mesh_auto_equals_no_mesh(tiny_burst, tmp_path, extra):
    """``--mesh auto`` with ``--device cpu`` (a one-shard CPU mesh) and
    ``--mesh 1``: the same PNGs as the run without ``--mesh``."""
    base = [str(tiny_burst), "--device", "cpu", "--scale-width", "64",
            "--match-ratio", "0.95"] + ECC_FAST + extra
    outs = {}
    for tag, mesh in (("none", []), ("auto", ["--mesh", "auto"]),
                      ("one", ["--mesh", "1"])):
        outs[tag] = tmp_path / tag
        assert stack_burst.main(base + ["--out", str(outs[tag])] + mesh) == 0
    names = sorted(p.name for p in outs["none"].iterdir())
    assert names and names == sorted(p.name for p in outs["auto"].iterdir())
    for name in names:
        want = np.asarray(Image.open(outs["none"] / name))
        for tag in ("auto", "one"):
            got = np.asarray(Image.open(outs[tag] / name))
            if name.startswith("ecc") or not extra:
                np.testing.assert_array_equal(got, want)
            else:
                # the keypoint stream over a mesh draws per (chunk, shard)
                assert np.abs(got.astype(int) - want).mean() < 2.0


def test_runs_as_a_module():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "libstacker_tpu_torch.stack_burst", "--help"],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--stream" in res.stdout
