"""The port's JPEG/PNG decoder and frame-directory reader against PIL and
the JAX package.

The cases of tests/_torch_make_frames.py (JPEG at quality 50 and 95,
4:4:4, 4:2:2, 4:2:0 and, written by hand, 4:4:0 and mixed ratios; grey;
progressive; optimized tables; restart markers; 1x1, 37x29, 64x48; PNG
colour types 0/2/3/4/6 at depths 1 to 16, tRNS, Adam7) are made from a
seed here and decoded by `native.decode_image`, by its plain twin
`data/image.py` and by PIL (`Image.open(...).convert("RGB")`): PNG must
be exact, JPEG within 1 level of 255 (each case prints its count of
differing bytes; exactness is the aim, and the twin must equal the
native decoder exactly). Frame directories (jpg and png mixed, an
upper-case extension, other files beside them) go through the port's
`data.av.load_frames_for` and the JAX package's on the same directory:
equal where every picked decode is exact, else within 2/255 (a 1-level
decode difference and the resize's rounding). The committed fixtures of
`tests/torch_frames/`, which the card reads, must still be PIL's decode
of the committed images.
"""

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from viai_tpu.data import av as j_av
from viai_tpu.data.loader import create_dataloader as j_create_dataloader
from viai_tpu_torch import native
from viai_tpu_torch.data import audio, av, image
from viai_tpu_torch.data.loader import create_dataloader

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_make_frames as mk  # noqa: E402

JPEG_TOL = 1               # levels of 255, decode against PIL
DIR_TOL = 2 / 255          # frame directories against the JAX package
CASES = (*mk.JPEG_CASES, *mk.PNG_CASES)
CLIP, N_FRAMES, BATCH = 4032, 4, 2


@pytest.mark.parametrize("name", CASES)
def test_decoders_match_pil(name):
    data, ext = mk.case_bytes(name)
    ref = mk.pil_decode(data)
    got = native.decode_image(data)
    twin = image.decode_image_numpy(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(twin, got)
    n_diff = int((got != ref).sum())
    print(f"{name}{ext}: {n_diff} of {ref.size} bytes differ from PIL")
    if ext == ".png":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got.astype(int) - ref).max() <= JPEG_TOL


def test_idct_saturates_as_pil():
    """`coef_saturate` puts IDCT outputs past ±512 of the centre, where
    jidctint.c's range table would wrap them; PIL (libjpeg-turbo's SIMD
    IDCT) saturates them, and so does the port."""
    data, _ = mk.case_bytes("coef_saturate")
    reach = 0
    for c in image._jpeg_coefficients(data)["comps"]:
        x = (np.asarray(c.coef, np.int64).reshape(-1, 64) * c.q
             ).reshape(-1, 8, 8)
        ws = np.stack(image._idct_1d([x[:, k, :] for k in range(8)], 11), 1)
        out = image._idct_1d([ws[:, :, k] for k in range(8)], 18)
        reach = max(reach, max(int(np.abs(o).max()) for o in out))
    assert reach > 512
    np.testing.assert_array_equal(native.decode_image(data),
                                  mk.pil_decode(data))


@pytest.mark.parametrize("name", CASES)
def test_committed_fixture_is_pil_decode(name):
    """The card holds the native decoder against these .npy files."""
    ext = ".jpg" if name in mk.JPEG_CASES else ".png"
    with open(os.path.join(mk.FIXTURES, name + ext), "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(
        np.load(os.path.join(mk.FIXTURES, name + ".npy")), mk.pil_decode(data))


def test_committed_clip():
    clip = os.path.join(mk.FIXTURES, "clip")
    names = sorted(os.listdir(clip))
    assert names == [f"{t:05d}.jpg" for t in range(mk.CLIP_FRAMES)]
    for t in (0, mk.CLIP_FRAMES - 1):
        with open(os.path.join(clip, names[t]), "rb") as f:
            data = f.read()
        img = Image.open(io.BytesIO(data))
        assert img.size == (mk.CLIP_SIZE, mk.CLIP_SIZE)
        np.testing.assert_array_equal(native.decode_image(data),
                                      mk.pil_decode(data))
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(mk.FIXTURES) for f in files)
    assert total < 1 << 20


def _write(path, name):
    data, _ = mk.case_bytes(name)
    with open(path, "wb") as f:
        f.write(data)


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """Clip stems: `mixed/` holds jpeg and png frames of several sizes
    under .jpg, .JPG, .jpeg, .Jpeg and .png names, a text file and a
    subdirectory; `upper/` only .PNG names; `six/` six frames, where the
    JAX package's float64 window rule and the port's float32 one for
    npy stacks part at window (0.1, 0.9)."""
    root = tmp_path_factory.mktemp("frames")
    mixed = root / "mixed"
    mixed.mkdir()
    names = ["q95_420", "png_RGB8", "progressive_444", "png_P4_short_adam7",
             "q50_422", "grey", "coef_mixed", "png_L16_adam7", "restart_420",
             "png_LA8", "q75_420_1x1", "optimize_420"]
    exts = [".jpg", ".png", ".JPG", ".png", ".jpeg", ".Jpeg", ".jpg", ".png",
            ".jpg", ".PNG", ".jpg", ".jpg"]
    for i, (name, ext) in enumerate(zip(names, exts)):
        _write(mixed / f"f{i:03d}{ext}", name)
    (mixed / "notes.txt").write_text("not a frame")
    (mixed / "sub").mkdir()
    upper = root / "upper"
    upper.mkdir()
    for i, name in enumerate(("png_RGB8", "png_I16", "png_P2")):
        _write(upper / f"{i}.PNG", name)
    six = root / "six"
    six.mkdir()
    for i in range(6):
        _write(six / f"{i:02d}.jpg", list(mk.JPEG_CASES)[i])
    return root


def _decodes_exact(stem: str) -> bool:
    ok = True
    for f in os.listdir(stem):
        if f.lower().endswith(image.FRAME_EXTENSIONS):
            with open(os.path.join(stem, f), "rb") as fh:
                data = fh.read()
            ok &= np.array_equal(native.decode_image(data),
                                 mk.pil_decode(data))
    return ok


@pytest.mark.parametrize("window", [None, (0.3, 0.8), (0.1, 0.9)])
@pytest.mark.parametrize("size", [64, 48])
@pytest.mark.parametrize("stem", ["mixed", "upper", "six"])
def test_frame_dirs_match_jax(frame_dirs, stem, size, window):
    path = str(frame_dirs / stem)
    n = 5 if stem == "six" else 7
    got = av.load_frames_for(path, n, size, window)
    ref = j_av.load_frames_for(path, n, size, window)
    assert got.shape == ref.shape == (n, size, size, 3)
    assert got.dtype == ref.dtype == np.float32
    err = float(np.abs(got - ref).max())
    print(f"{stem} size {size} window {window}: max|Δ| {err:.3e}")
    if _decodes_exact(path):
        assert err == 0.0
    else:
        assert err <= DIR_TOL
    np.testing.assert_array_equal(
        image.frame_dir_numpy(path, n, size, window), got)


def test_window_rule_is_the_jax_packages(frame_dirs):
    """At (0.1, 0.9) of six frames the float64 rule picks frame 0 first
    (0.1·5 = 0.5, half to even) where the float32 one of npy stacks
    picks 1; the directory reader follows the JAX package."""
    w = (0.1, 0.9)
    assert image.window_indices(6, 5, w)[0] == 0
    assert av._window_indices(6, 5, w)[0] == 1
    np.testing.assert_array_equal(image.window_indices(6, 5, w),
                                  j_av._window_indices(6, 5, w))
    path = str(frame_dirs / "six")
    np.testing.assert_array_equal(
        native.load_frame_dir(path, 5, 32, w)[0],
        native.load_frame_dir(path, 1, 32, (0.0, 0.0))[0])


def test_threads_agree(frame_dirs):
    path = str(frame_dirs / "mixed")
    one = native.load_frame_dir(path, 9, 40, (0.05, 0.95), threads=1)
    for threads in (2, 5, 64):
        np.testing.assert_array_equal(
            native.load_frame_dir(path, 9, 40, (0.05, 0.95), threads=threads),
            one)


@pytest.mark.parametrize("workers", [0, 1, 4, 1000])
def test_worker_thread_bound(av_corpus, workers):
    """Each of the DataLoader's workers decodes over the host's cores
    divided among them."""
    cores = len(os.sched_getaffinity(0))
    for mode, root in (("av", av_corpus),
                       ("musices", av_corpus / "musices.json")):
        loader = create_dataloader(mode, str(root), batch_size=BATCH,
                                   clip_samples=CLIP, n_threads=workers,
                                   n_frames=N_FRAMES, frame_size=32)
        assert loader.dataset.frame_threads == max(cores // max(workers, 1),
                                                   1)


def _tone(n, rng):
    t = np.arange(n) / 16000
    return 0.3 * np.sin(2 * np.pi * rng.uniform(200, 800) * t) \
        + 0.01 * rng.standard_normal(n)


@pytest.fixture(scope="module")
def av_corpus(tmp_path_factory):
    """Four clips whose frames are jpeg/png directories, and a musices
    manifest over them."""
    root = tmp_path_factory.mktemp("avcorpus")
    rng = np.random.default_rng(2)
    kinds = ["q95_420", "png_RGB8", "progressive_420", "png_P8_adam7",
             "q50_444", "png_RGBA16"]
    for c in range(4):
        audio.write_wav(str(root / f"c{c}.wav"), _tone(8000, rng), 16000)
        (root / f"c{c}").mkdir()
        for t in range(5):
            name = kinds[(c + t) % len(kinds)]
            ext = ".jpg" if name in mk.JPEG_CASES else ".png"
            _write(root / f"c{c}" / f"{t:04d}{ext}", name)
    manifest = {"train": [{"audio": f"c{c}.wav", "frames": f"c{c}"}
                          for c in range(4)],
                "test": [{"audio": "c3.wav", "frames": "c3"}] * 2}
    with open(root / "musices.json", "w") as f:
        json.dump(manifest, f)
    return root


@pytest.mark.parametrize("mode,split", [("av", "train"),
                                        ("musices", "train"),
                                        ("musices", "test")])
def test_loader_batches_match_jax(av_corpus, mode, split):
    root = str(av_corpus / "musices.json") if mode == "musices" \
        else str(av_corpus)
    kw = dict(batch_size=BATCH, clip_samples=CLIP, sample_rate=16000,
              n_threads=0, n_frames=N_FRAMES, frame_size=32, seed=3,
              shuffle=False, num_epochs=1, prefer_native=False, split=split)
    ours = list(create_dataloader(mode, root, **kw))
    theirs = list(j_create_dataloader(mode, root, **kw))
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        assert a["frames"].shape == (BATCH, N_FRAMES, 32, 32, 3)
        for k in a:
            assert a[k].dtype == torch.float32
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def _corrupt_cases():
    jpeg, _ = mk.case_bytes("q95_420")
    prog, _ = mk.case_bytes("progressive_420")
    png, _ = mk.case_bytes("png_RGB8")
    sof = jpeg.index(b"\xff\xc0")
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    flipped = bytearray(png)
    flipped[len(png) // 2] ^= 0x40
    return {
        "jpeg cut in its scan": (jpeg[:len(jpeg) // 2], ValueError),
        "progressive jpeg cut in its last scan":
            (prog[:(scans[-1] + len(prog)) // 2] + b"\xff\xd9", ValueError),
        "progressive jpeg without its last scans":
            (prog[:scans[3]] + b"\xff\xd9", NotImplementedError),
        "jpeg without EOI": (jpeg[:-2], ValueError),
        "png with a flipped bit": (bytes(flipped), ValueError),
        "png cut short": (png[:len(png) // 2], ValueError),
        "not an image": (b"\x00" * 64, ValueError),
        "arithmetic jpeg": (jpeg[:sof] + b"\xff\xc9" + jpeg[sof + 2:],
                            NotImplementedError),
        "12-bit jpeg": (jpeg[:sof + 4] + b"\x0c" + jpeg[sof + 5:],
                        NotImplementedError),
        "lossless jpeg": (jpeg[:sof] + b"\xff\xc3" + jpeg[sof + 2:],
                          NotImplementedError),
        "gif": (b"GIF89a" + bytes(32), NotImplementedError),
    }


@pytest.mark.parametrize("case", sorted(_corrupt_cases()))
def test_broken_and_unsupported_files_raise(tmp_path, case):
    data, error = _corrupt_cases()[case]
    with pytest.raises(error):
        native.decode_image(data)
    with pytest.raises(error):
        image.decode_image_numpy(data)
    stem = tmp_path / "clip"
    stem.mkdir()
    shutil.copy(os.path.join(mk.FIXTURES, "q50_420.jpg"), stem / "0.jpg")
    (stem / "1.jpg").write_bytes(data)
    with pytest.raises(error, match="1.jpg"):
        av.load_frames_for(str(stem), 2, 16)


def test_directory_without_frames_raises(tmp_path):
    stem = tmp_path / "clip"
    stem.mkdir()
    (stem / "readme.txt").write_text("no frames here")
    with pytest.raises(FileNotFoundError, match="no frames"):
        av.load_frames_for(str(stem), 2, 16)
    with pytest.raises(FileNotFoundError, match="no frames"):
        image.frame_dir_numpy(str(stem), 2, 16)
