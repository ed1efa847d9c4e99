"""Folder data of the port against viai_tpu's, and its native readers
against its numpy ones.

A small corpus is written from a seed into a temporary directory: wav
files (PCM16 at 16 kHz, one at 22.05 kHz, one stereo, one float32, one
shorter than a clip), `.npy` frame stacks (C-ordered uint8, one at
another size so the frames are resized; a float32 and a Fortran-ordered
uint8 one at other sizes, which both packages read in numpy), an
uncompressed AVI and a musices manifest with train and test splits.
Items and in-order batches must equal the JAX package's for the same
(seed, idx), bit for bit: both read native stacks through the same C++
sources, each package through its own build, and the port's
`resample_frames` repeats the JAX package's Pillow resize in numpy. The
native decoder and resampler equal the numpy ones bit for bit; the
native frame reader matches numpy's within 1e-6 (float32 sums in
another order).
"""

import json
import os

import numpy as np
import pytest
import torch

import viai_tpu.native as j_native
from viai_tpu.data import audio as j_audio
from viai_tpu.data import av as j_av
from viai_tpu.data import avi as j_avi
from viai_tpu.data.loader import create_dataloader as j_create_dataloader
from viai_tpu_torch import _build, native
from viai_tpu_torch.data import audio, av, avi
from viai_tpu_torch.data.loader import EpochSampler, create_dataloader
from viai_tpu_torch.data.prefetch import device_prefetch

CLIP, N_FRAMES, SIZE, BATCH, N_TRAIN = 4032, 4, 16, 2, 4
FRAMES_TOL = 1e-6
# name: (sample rate, channels, format, seconds, frames: npy (T, H, W) or
# "avi" or None)
CLIPS = {
    "a0": (16000, 1, "pcm16", 0.5, (10, 16, 16)),
    "a1": (16000, 1, "pcm16", 0.5, (12, 20, 24)),
    "b_22k": (22050, 1, "pcm16", 0.5, "avi"),
    "c_stereo": (16000, 2, "pcm16", 0.5, (10, 16, 16)),
    "d_float": (16000, 1, "float32", 0.5, (10, 16, 16)),
    "e_short": (16000, 1, "pcm16", 0.2, (6, 16, 16)),
    "f_float_stack": (16000, 1, "pcm16", 0.5, (10, 20, 24)),
    "g_fortran_stack": (16000, 1, "pcm16", 0.5, (9, 40, 12)),
}
# Stacks that neither package's native reader takes (C-ordered uint8
# otherwise).
STACK_LAYOUT = {"f_float_stack": "float32", "g_fortran_stack": "fortran"}


def _stack(shape, layout, rng):
    if layout == "float32":
        return rng.random((*shape, 3), np.float32)
    x = rng.integers(0, 256, (*shape, 3), np.uint8)
    return np.asfortranarray(x) if layout == "fortran" else x


def _tone(n, sr, ch, rng):
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 800) * t)[:, None]
    return x + 0.01 * rng.standard_normal((n, ch))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for name, (sr, ch, fmt, secs, frames) in CLIPS.items():
        audio.write_wav(str(root / f"{name}.wav"),
                        _tone(int(secs * sr), sr, ch, rng), sr, fmt)
        if frames == "avi":
            avi.write_avi(str(root / f"{name}.avi"),
                          rng.integers(0, 256, (8, 16, 16, 3), np.uint8), 16)
        else:
            np.save(root / f"{name}.npy",
                    _stack(frames, STACK_LAYOUT.get(name), rng))
    names = sorted(CLIPS)
    manifest = {split: [{"audio": f"{n}.wav", "frames": f"{n}.npy"}
                        for n in part]
                for split, part in (("train", names[:N_TRAIN]),
                                    ("test", names[N_TRAIN:]))}
    with open(root / "musices.json", "w") as f:
        json.dump(manifest, f)
    return root


def _kw(**extra):
    return dict(clip_samples=CLIP, sample_rate=16000, seed=3, **extra)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_load_wav_matches_jax(corpus, name):
    # The JAX package builds its library when imported; a build that
    # another test process had half written is retried here.
    assert j_native.AVAILABLE or j_native._load() is not None, \
        "the JAX package's native library is built"
    path = str(corpus / f"{name}.wav")
    np.testing.assert_array_equal(audio.load_wav(path),
                                  j_audio.load_wav(path))


@pytest.mark.parametrize("fmt", sorted(audio.WAV_FORMATS))
@pytest.mark.parametrize("channels", [1, 2])
def test_native_decoder_matches_numpy(tmp_path, fmt, channels):
    rng = np.random.default_rng(len(fmt) + channels)
    path = str(tmp_path / "x.wav")
    audio.write_wav(path, _tone(3001, 16000, channels, rng), 22050, fmt)
    with open(path, "rb") as f:
        data = f.read()
    wav, sr = native.decode_wav(data)
    ref, ref_sr = audio.read_wav_numpy(data)
    assert sr == ref_sr == 22050 and wav.shape == (3001,)
    np.testing.assert_array_equal(wav, ref)
    np.testing.assert_array_equal(native.resample_linear(wav, 22050, 16000),
                                  audio.resample_linear_numpy(ref, 22050,
                                                              16000))
    with pytest.raises(ValueError):
        native.decode_wav(data[:40])
    with pytest.raises(ValueError):
        audio.read_wav_numpy(data[:40])


@pytest.mark.parametrize("window", [None, (0.2, 0.7)])
@pytest.mark.parametrize("name", ["a0", "a1", "b_22k"])
def test_native_frames_match_numpy(corpus, name, window):
    if CLIPS[name][-1] == "avi":
        path = str(corpus / f"{name}.avi")
        arr = avi.read_avi(path)[0]
    else:
        path = str(corpus / f"{name}.npy")
        arr = np.load(path)
    out = native.load_frames(path, N_FRAMES, SIZE, window)
    ref = av.frames_numpy(arr, N_FRAMES, SIZE, window)
    assert out.shape == (N_FRAMES, SIZE, SIZE, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FRAMES_TOL)


@pytest.mark.parametrize("layout", ["uint8", "float32", "fortran"])
@pytest.mark.parametrize("shape,size", [((7, 40, 12), 16),
                                        ((5, 9, 30), 64)])
def test_resample_frames_matches_jax(layout, shape, size):
    """The numpy path for stacks that the native readers refuse, against
    viai_tpu's `_resample_frames` (Pillow), shrinking and enlarging."""
    rng = np.random.default_rng(size + len(layout))
    arr = _stack(shape, layout, rng)
    for window in (None, (0.25, 0.8)):
        np.testing.assert_array_equal(
            av.resample_frames(arr, N_FRAMES, size, window),
            j_av._resample_frames(arr, N_FRAMES, size, window=window))


def test_avi_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (5, 12, 10, 3), np.uint8)
    sound = rng.uniform(-0.5, 0.5, 1600).astype(np.float32)
    ours, theirs = str(tmp_path / "p.avi"), str(tmp_path / "j.avi")
    avi.write_avi(ours, frames, 10, sound, 16000)
    j_avi.write_avi(theirs, frames, 10, sound, 16000)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got, ref = avi.read_avi(ours), j_avi.read_avi(ours)
    np.testing.assert_array_equal(got[0], frames)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _assert_items(ours, theirs, indices):
    for i in indices:
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_datasets_match_jax(corpus):
    root = str(corpus)
    n = len(CLIPS)
    # Raw indices past one epoch: fresh crops, as EpochSampler reads.
    idx = list(range(2 * n)) + [5 * n + 1]
    _assert_items(audio.AudioFolderDataset(root, **_kw()),
                  j_audio.AudioFolderDataset(root, **_kw()), idx)
    fkw = _kw(n_frames=N_FRAMES, frame_size=SIZE)
    _assert_items(av.AVFolderDataset(root, **fkw),
                  j_av.AVFolderDataset(root, **fkw), idx)
    manifest = str(corpus / "musices.json")
    for split in ("train", "test"):
        ours = av.MusicesManifest(manifest, split, **fkw)
        theirs = j_av.MusicesManifest(manifest, split, **fkw)
        assert len(ours) == len(theirs) == (
            N_TRAIN if split == "train" else len(CLIPS) - N_TRAIN)
        _assert_items(ours, theirs, range(2 * len(ours)))
    with pytest.raises(KeyError, match="val"):
        av.MusicesManifest(manifest, "val")


@pytest.mark.parametrize("mode", ["audio", "av", "musices"])
def test_in_order_batches_match_jax(corpus, mode):
    root = str(corpus / "musices.json") if mode == "musices" else str(corpus)
    kw = dict(batch_size=BATCH, clip_samples=CLIP, sample_rate=16000,
              n_threads=0, n_frames=N_FRAMES, frame_size=SIZE, seed=3,
              shuffle=False, num_epochs=1, prefer_native=False, split="test")
    ours = list(create_dataloader(mode, root, **kw))
    theirs = list(j_create_dataloader(mode, root, **kw))
    n = len(CLIPS) - N_TRAIN if mode == "musices" else len(CLIPS)
    assert len(ours) == len(theirs) == n // BATCH
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == torch.float32
            np.testing.assert_array_equal(a[k].numpy(), b[k])


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_sampler_offsets_each_epoch(shuffle):
    """Epoch e holds the records e·n … e·n + n − 1 (mod 1024 epochs), in
    order or permuted by (seed, e)."""
    n, epochs = 5, EpochSampler.VIRTUAL_EPOCHS + 2
    idx = np.array(list(EpochSampler(n, shuffle, 7, epochs)))
    assert len(idx) == len(EpochSampler(n, shuffle, 7, epochs)) == n * epochs
    for e in (0, 1, 2, epochs - 2, epochs - 1):
        got = idx[e * n:(e + 1) * n]
        base = (e % EpochSampler.VIRTUAL_EPOCHS) * n
        assert sorted(got) == list(range(base, base + n))
        if not shuffle:
            assert list(got) == list(range(base, base + n))
    assert shuffle == (list(idx[:n]) != list(range(n)))
    with pytest.raises(TypeError):
        len(EpochSampler(n, shuffle, 7, None))


def test_shuffled_loader_in_workers(corpus):
    """Two spawned workers, endless shuffled epochs of fresh crops: each
    batch holds the items of EpochSampler's indices."""
    loader = create_dataloader("av", str(corpus), batch_size=4,
                               clip_samples=CLIP, n_threads=2,
                               n_frames=N_FRAMES, frame_size=SIZE, seed=3)
    n = len(CLIPS)
    assert loader.epoch_batches == n // 4
    src = av.AVFolderDataset(str(corpus), **_kw(n_frames=N_FRAMES,
                                                frame_size=SIZE))
    order = iter(EpochSampler(n, True, 3, None))
    batches = iter(loader)
    for _ in range(3):           # into the second epoch
        batch = next(batches)
        for b in range(4):
            item = src[next(order)]
            for k, v in item.items():
                np.testing.assert_array_equal(batch[k][b].numpy(), v)
    del batches


def test_native_clip_loader(corpus):
    it = create_dataloader("audio", str(corpus), batch_size=3,
                           clip_samples=CLIP, n_threads=1, seed=5)
    again = create_dataloader("audio", str(corpus), batch_size=3,
                              clip_samples=CLIP, n_threads=1, seed=5)
    try:
        a, b = next(it)["wav"], next(again)["wav"]
        assert a.shape == (3, CLIP) and np.isfinite(a).all() and a.any()
        np.testing.assert_array_equal(a, b)    # one worker: reproducible
    finally:
        it.close()
        again.close()


def test_device_prefetch_on_the_cpu(corpus):
    batches = [{"wav": np.full((2, 3), float(i), np.float32)}
               for i in range(5)]
    for depth in (1, 2, 8):
        out = list(device_prefetch(iter(batches), "cpu", depth=depth))
        assert len(out) == 5
        for i, b in enumerate(out):
            assert torch.is_tensor(b["wav"]) and b["wav"].device.type == "cpu"
            torch.testing.assert_close(b["wav"], torch.full((2, 3), float(i)))


def test_unsupported_layouts_raise(tmp_path):
    stem = str(tmp_path / "clip")
    os.makedirs(stem)
    with pytest.raises(NotImplementedError, match="directory of image"):
        av.load_frames_for(stem, N_FRAMES, SIZE)
    os.rmdir(stem)
    open(stem + ".mp4", "wb").close()
    with pytest.raises(NotImplementedError, match="compressed video"):
        av.load_frames_for(stem, N_FRAMES, SIZE)
    os.remove(stem + ".mp4")
    avi.write_avi(stem + ".avi", np.zeros((2, 8, 8, 3), np.uint8), 10)
    with open(stem + ".avi", "rb") as f:
        data = f.read()
    with open(stem + ".avi", "wb") as f:     # claim MJPG compression
        f.write(data.replace(b"RGBA", b"MJPG"))
    with pytest.raises(NotImplementedError, match="compressed"):
        av.load_frames_for(stem, N_FRAMES, SIZE)
    with pytest.raises(FileNotFoundError):
        av.load_frames_for(str(tmp_path / "none"), N_FRAMES, SIZE)


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_failed_native_build_raises(monkeypatch, cxx):
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="not found|failed"):
        _build.build(["native"])
