"""The camera sensor path of the port against the JAX package's, both on the
CPU, on files written into ``tmp_path`` from seeded numpy data.

Tolerances: the photometric correction (K18's plain version) within 2 ulp of
JAX's ``correct_image`` and of the native ``photometric_correct`` (XLA and
the native build may contract the interpolation into an FMA; the port rounds
each product); calibrations: equal intrinsics; providers: equal ids,
timestamps, exposures and pixels; the camera's frames within 2 ulp of JAX's
``Camera.next_frame``; ``build_remaps`` in f64 within 1e-6 px of the JAX
models' projection of the same rays, and equal to JAX's f32 tables once
rounded to f32; the remap within the frame's largest gradient × 1/64 px +
1e-4 of ``cv2.remap``, which quantises its weights to 1/32 px, also for a
SimpleRadial and a TumFov camera's frames through ``Camera.next_frame``
(identity G⁻¹, no vignette); masks exact.  The camera's intake (K18's plain
version: remap, crop and correction) equal to the bit to the chain it
replaced.
"""

import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsopp_tpu.native import photometric_correct as native_correct
from dsopp_tpu.sensors import calibration as jcal
from dsopp_tpu.sensors import camera as jcam
from dsopp_tpu.sensors import masks as jmasks
from dsopp_tpu.sensors import providers as jprov
from dsopp_tpu.sensors import undistorter as jund
from dsopp_tpu.sensors.photometric import correct_image as jax_correct
from dsopp_tpu_torch import convert
from dsopp_tpu_torch.sensors import calibration, masks, providers, undistorter
from dsopp_tpu_torch.sensors.camera import Camera, CameraSettings, crop_size_power_of_2
from dsopp_tpu_torch.sensors.photometric import (correct_image, correct_image_cuda,
                                                 correct_image_plain, intake_plain)

import tests._torch_port  # noqa: F401  (one torch thread per worker)

H, W = 48, 68          # a width that is not a multiple of 4 or of 16
ULP = 2


def _ulp_close(actual, expected, ulps=ULP):
    actual, expected = np.asarray(actual, np.float32), np.asarray(expected, np.float32)
    gap = np.abs(actual.astype(np.float64) - expected.astype(np.float64))
    allowed = ulps * np.spacing(np.abs(expected)).astype(np.float64)
    assert np.all(gap <= allowed), float(np.max(gap / np.maximum(allowed, 1e-30)))


def _lut(rng):
    return np.cumsum(rng.uniform(0.2, 1.8, 256)).astype(np.float32)


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("with_vignette", [False, True])
def test_correct_image_matches_jax_and_native(u8, with_vignette):
    rng = np.random.default_rng(3)
    if u8:
        raw = rng.integers(0, 256, (H, W)).astype(np.uint8)
    else:
        raw = rng.uniform(-20.0, 275.0, (H, W)).astype(np.float32)
        raw[0, :8] = [0.0, 255.0, 254.5, 17.0, -0.0, 1e-8, 254.99998, 128.25]
    lut = _lut(rng)
    vig = rng.uniform(-0.01, 1.0, (H, W)).astype(np.float32) if with_vignette else None
    raw32 = raw.astype(np.float32)
    out = correct_image(torch.as_tensor(raw), torch.as_tensor(lut),
                        None if vig is None else torch.as_tensor(vig))
    assert out.dtype == torch.float32 and tuple(out.shape) == (H, W)
    ref = jax_correct(jnp.asarray(raw32), jnp.asarray(lut),
                      None if vig is None else jnp.asarray(vig))
    _ulp_close(out.numpy(), np.asarray(ref))
    _ulp_close(out.numpy(), native_correct(raw32, lut, vig))


def test_correct_image_f64_and_cuda_refusal():
    rng = np.random.default_rng(4)
    raw = rng.uniform(0.0, 255.0, (H, W))
    lut = _lut(rng).astype(np.float64)
    out = correct_image_plain(torch.as_tensor(raw), torch.as_tensor(lut))
    ref = jax_correct(jnp.asarray(raw), jnp.asarray(lut))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-15, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        correct_image_cuda(torch.as_tensor(raw.astype(np.float32)),
                           torch.as_tensor(lut.astype(np.float32)))


CALIBS = {
    "pinhole": "pinhole\n640 480\n520.5 519.25 319.5 239.75\n",
    "simple_radial": "simple_radial\n640 480\n300 320 240 -0.05 0.004\n",
    "tum_fov": "tum_fov\n640 480\n0.55 0.71 0.499 0.502 0.93\n",
    "ios": "ios\n640 480\n500 502 320 240 " + " ".join(
        repr(float(v)) for v in 0.06 * np.linspace(0, 1, 12) ** 2) + "\n",
}


@pytest.mark.parametrize("tag", sorted(CALIBS))
def test_calibration_parsing_matches(tmp_path, tag):
    path = tmp_path / "calib.txt"
    path.write_text(CALIBS[tag])
    port, ref = calibration.load_calibration(str(path)), jcal.load_calibration(str(path))
    assert port.model_type == ref.model_type == tag
    assert port.image_size == ref.image_size
    np.testing.assert_array_equal(port.intrinsics, ref.intrinsics)
    for level in (0, 2):
        model = port.camera_model(level)
        jmodel = ref.camera_model(level, jnp.float64)
        for name, value in jmodel._asdict().items():
            if name == "image_size":
                assert (model.width, model.height) == tuple(np.asarray(value))
            elif name == "lut":
                np.testing.assert_array_equal(model.lut, np.asarray(value))
            else:
                assert getattr(model, name) == float(value), name
    same = convert.camera_model(ref.model_type, ref.image_size, ref.intrinsics)
    assert same == port.camera_model()


def test_photometric_calibration_identity_on_missing_or_short_file(tmp_path):
    short = tmp_path / "short.txt"
    short.write_text("1 2 3")
    for path in (None, str(tmp_path / "missing.txt"), str(short)):
        np.testing.assert_array_equal(calibration.load_photometric_calibration(path),
                                      jcal.load_photometric_calibration(path))
    full = tmp_path / "pcalib.txt"
    full.write_text(" ".join(str(0.9 * v) for v in range(256)))
    np.testing.assert_array_equal(calibration.load_photometric_calibration(str(full)),
                                  jcal.load_photometric_calibration(str(full)))


@pytest.fixture
def dataset(tmp_path):
    """Five 8-bit frames as png and as npy, a times file with exposures, a
    calibration, a photometric calibration, a 16-bit vignette and a video."""
    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    (tmp_path / "npy").mkdir()
    video = cv2.VideoWriter(str(tmp_path / "video.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                            (W, H), False)
    for i in range(5):
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        cv2.imwrite(str(tmp_path / "images" / f"{i}.png"), img)
        np.save(tmp_path / "npy" / f"{i}.npy", img)
        video.write(img)
    video.release()
    (tmp_path / "times.txt").write_text(
        "# id timestamp exposure\n" + "".join(f"{i} {0.1 * i:.3f} {1.0 + 0.1 * i}\n"
                                              for i in range(5)))
    (tmp_path / "times.csv").write_text("frame,ts\n" + "".join(f"{i},{0.5 * i}\n"
                                                               for i in range(5)))
    (tmp_path / "calib.txt").write_text(f"pinhole\n{W} {H}\n40 41 33.5 23.5\n")
    (tmp_path / "pcalib.txt").write_text(" ".join(repr(float(v)) for v in _lut(rng)))
    vig = (65535 * rng.uniform(0.5, 1.0, (H, W))).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "vignette.png"), vig)
    return tmp_path


def _frames(provider):
    frames = []
    while (f := provider.next_frame()) is not None:
        frames.append(f)
    return frames


@pytest.mark.parametrize("kind", ["image_folder", "npy_folder", "video"])
@pytest.mark.parametrize("start_frame", [0, 2])
def test_providers_match(dataset, kind, start_frame):
    folder = {"image_folder": "images", "npy_folder": "npy"}.get(kind)
    params = {"type": kind, "start_frame": start_frame}
    if kind == "video":
        params.update(video_file=str(dataset / "video.avi"),
                      timestamps=str(dataset / "times.csv"))
    else:
        params.update(folder=str(dataset / folder), timestamps=str(dataset / "times.txt"))
    port = _frames(providers.create_provider(params))
    ref = _frames(jprov.create_provider(params))
    assert [f.frame_id for f in port] == [f.frame_id for f in ref] == list(range(start_frame, 5))
    for a, b in zip(port, ref):
        assert (a.timestamp, a.exposure) == (b.timestamp, b.exposure)
        np.testing.assert_array_equal(np.asarray(a.image, np.float32), b.image)
    if kind == "npy_folder":
        assert all(f.image.dtype == np.uint8 for f in port)    # as stored


def _camera_params(resize):
    params = {"provider": {"type": "image_folder", "folder": "images",
                           "timestamps": "times.txt"},
              "model": {"calibration": "calib.txt", "photometric_calibration": "pcalib.txt",
                        "vignetting": "vignette.png"}}
    if resize != 1.0:
        params["transformations"] = {"resize_transformer": {"resize_ratio": resize}}
    return params


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_camera_pipeline_matches(dataset, resize):
    """provider → (resize) → crop to a multiple of 16 → G⁻¹ and vignette."""
    params = _camera_params(resize)
    cam = Camera.from_config("camera_1", params, base_dir=str(dataset), device="cpu")
    jc = jcam.Camera.from_config("camera_1", params, base_dir=str(dataset))
    model, jmodel = cam.camera_model(), jc.camera_model(0, jnp.float64)
    assert (model.width, model.height) == tuple(np.asarray(jmodel.image_size))
    assert (model.fx, model.cy) == (float(jmodel.fx), float(jmodel.cy))
    np.testing.assert_array_equal(cam.processed_mask().numpy(), np.asarray(jc.processed_mask()))
    for _ in range(5):
        a, b = cam.next_frame(), jc.next_frame()
        assert (a.frame_id, a.timestamp, a.exposure) == (b.frame_id, b.timestamp, b.exposure)
        assert a.image.dtype == torch.float32
        assert tuple(a.image.shape) == np.asarray(b.image).shape
        _ulp_close(a.image.numpy(), np.asarray(b.image))
    assert cam.next_frame() is None and jc.next_frame() is None


@pytest.mark.parametrize("stored", ["uint8", "uint16", "float64"])
@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_npy_camera_matches_for_each_stored_dtype(dataset, stored, resize):
    """An npy folder of u8, u16 or f64 frames (``np.save`` of a float array
    writes f64): the provider keeps u8 and gives f32 for the others, and the
    camera's frames lie within 2 ulp of JAX's ``Camera.next_frame``."""
    rng = np.random.default_rng(9)
    folder = dataset / f"npy_{stored}"
    folder.mkdir()
    top = {"uint8": 255, "uint16": 400, "float64": 270.0}[stored]
    for i in range(3):
        np.save(folder / f"{i}.npy", (rng.uniform(-5.0, 1.0, (H, W)) + rng.uniform(0, top, (H, W)))
                .clip(0).astype(stored))
    params = dict(_camera_params(resize),
                  provider={"type": "npy_folder", "folder": folder.name,
                            "timestamps": "times.txt"})
    cam = Camera.from_config("camera_1", params, base_dir=str(dataset), device="cpu")
    jc = jcam.Camera.from_config("camera_1", params, base_dir=str(dataset))
    raw = providers.NpyFolderProvider(str(folder)).next_frame().image
    assert raw.dtype == (np.uint8 if stored == "uint8" else np.float32)
    for _ in range(3):
        a, b = cam.next_frame(), jc.next_frame()
        assert a.image.dtype == torch.float32
        assert tuple(a.image.shape) == np.asarray(b.image).shape
        _ulp_close(a.image.numpy(), np.asarray(b.image))
    assert cam.next_frame() is None


def _replaced_chain(image, maps, resize, lut, vignette):
    """The camera's chain before K18 took it in: upload, remap, resize on the
    host, crop with a copy, correction."""
    img = torch.as_tensor(image)
    if maps is not None:
        img = undistorter.remap_bilinear(img.to(torch.float32), *maps)
    if resize != 1.0:
        host = img.numpy() if maps is not None else image.astype(np.float32)
        img = torch.as_tensor(cv2.resize(host, None, fx=resize, fy=resize,
                                         interpolation=cv2.INTER_AREA))
    cw, ch = crop_size_power_of_2(img.shape[1], img.shape[0], 4)
    img = img[:ch, :cw].contiguous()
    if vignette.shape != img.shape:
        vignette = cv2.resize(vignette, (cw, ch), interpolation=cv2.INTER_AREA)
    return correct_image_plain(img, lut, torch.as_tensor(vignette))


@pytest.mark.parametrize("model", ["pinhole", "simple_radial"])
@pytest.mark.parametrize("width", [64, 68])
@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_camera_intake_equals_the_replaced_chain(dataset, model, width, resize):
    """``Camera.next_frame`` on the CPU (the intake's plain version) equals to
    the bit the chain it replaced, without and with undistortion tables, for
    a crop that keeps the size (64 columns) and one that changes it (68), at
    resize 1 and 0.5."""
    rng = np.random.default_rng(17)
    folder = dataset / f"intake_{model}_{width}"
    folder.mkdir()
    frames = [rng.integers(0, 256, (H, width)).astype(np.uint8) for _ in range(3)]
    for i, frame in enumerate(frames):
        np.save(folder / f"{i}.npy", frame)
    intr = {"pinhole": "40 41 33.5 23.5", "simple_radial": "40 33.5 23.5 -0.15 0.01"}[model]
    (folder / "calib.txt").write_text(f"{model}\n{width} {H}\n{intr}\n")
    vignette = rng.uniform(0.5, 1.0, (H, width)).astype(np.float32)
    params = {"provider": {"type": "npy_folder", "folder": folder.name,
                           "timestamps": "times.txt"},
              "model": {"calibration": f"{folder.name}/calib.txt",
                        "photometric_calibration": "pcalib.txt"}}
    if resize != 1.0:
        params["transformations"] = {"resize_transformer": {"resize_ratio": resize}}
    cam = Camera.from_config("camera_1", params, base_dir=str(dataset), device="cpu")
    cam.settings.vignetting = vignette
    und = cam.settings.undistorter
    maps = None if und is None else und.maps32()
    assert (maps is None) == (model == "pinhole")
    lut = torch.as_tensor(calibration.load_photometric_calibration(str(dataset / "pcalib.txt")))
    for frame in frames:
        out = cam.next_frame().image
        expected = _replaced_chain(frame, maps, resize, lut, vignette)
        assert out.dtype == torch.float32 and out.shape == expected.shape
        assert torch.equal(out, expected)
    assert cam.next_frame() is None
    if resize == 1.0:       # the intake's own arguments: the crop is a view, not a copy
        h, w = expected.shape
        vig = torch.as_tensor(vignette[:h, :w].copy())
        np.testing.assert_array_equal(
            intake_plain(frames[0], lut, vig, maps, (h, w)).numpy(),
            _replaced_chain(frames[0], maps, 1.0, lut, vig.numpy()).numpy())


def test_pinned_ring_waits_for_its_buffers(monkeypatch):
    """The ring's bookkeeping on the CPU (pinned memory and events faked): a
    buffer is written again only once its event reports the copy done, each
    time it was not counts one wait, and a new shape makes new buffers."""
    from dsopp_tpu_torch.sensors import pinned

    class Event:
        def __init__(self):
            self.polls = 0

        def record(self):
            self.polls = 2          # done at the second poll after the copy is queued

        def query(self):
            self.polls -= 1
            return self.polls <= 0

    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    ring = pinned.PinnedRing(slots=3)
    staged = []
    for i in range(5):
        buf, copied = ring.stage(np.full((4, 6), i, np.uint8))
        assert buf.dtype == torch.uint8 and bool((buf == i).all())
        copied.record()                          # the copy is queued
        staged.append((buf.data_ptr(), copied))
    assert staged[3] == staged[0] and staged[4] == staged[1] and len(set(staged[:3])) == 3
    assert ring.waits == 2                       # the 4th and 5th frames found copies in flight
    wide, _ = ring.stage(np.ones((2, 3), np.float32))
    assert wide.dtype == torch.float32 and wide.shape == (2, 3)


DISTORTED_CALIBS = {"simple_radial": "80 64 48 -0.15 0.01",
                    "tum_fov": "0.52 0.72 0.47 0.48 0.9"}


@pytest.mark.parametrize("tag", sorted(DISTORTED_CALIBS))
def test_distorted_camera_matches_jax(dataset, tag):
    """A SimpleRadial and a TumFov camera (136 x 100, cropped to 128 x 96)
    through ``Camera.next_frame`` against the JAX package's camera (tables
    built through its models, ``cv2.remap``): identity G⁻¹ and no vignette,
    smooth f32 frames, within the remap's tolerance (the frame's largest
    gradient / 64 + 1e-4)."""
    rng = np.random.default_rng(23)
    h, w = 100, 136
    folder = dataset / f"distorted_{tag}"
    folder.mkdir()
    frames = [cv2.GaussianBlur(rng.uniform(0, 255, (h, w)).astype(np.float32), (5, 5), 1.5)
              for _ in range(3)]
    for i, frame in enumerate(frames):
        np.save(folder / f"{i}.npy", frame)
    (folder / "calib.txt").write_text(f"{tag}\n{w} {h}\n{DISTORTED_CALIBS[tag]}\n")
    params = {"provider": {"type": "npy_folder", "folder": folder.name,
                           "timestamps": "times.txt"},
              "model": {"calibration": f"{folder.name}/calib.txt"}}
    cam = Camera.from_config("camera_1", params, base_dir=str(dataset), device="cpu")
    jc = jcam.Camera.from_config("camera_1", params, base_dir=str(dataset))
    assert cam.settings.undistorter is not None and not cam.settings.undistorter.identity
    model, jmodel = cam.camera_model(), jc.camera_model(0, jnp.float64)
    assert (model.width, model.height) == tuple(np.asarray(jmodel.image_size)) == (128.0, 96.0)
    for frame in frames:
        a, b = cam.next_frame(), jc.next_frame()
        assert a.image.dtype == torch.float32
        assert tuple(a.image.shape) == np.asarray(b.image).shape == (96, 128)
        grad = max(np.abs(np.diff(frame, axis=0)).max(), np.abs(np.diff(frame, axis=1)).max())
        np.testing.assert_allclose(a.image.numpy(), np.asarray(b.image), atol=grad / 64 + 1e-4,
                                   rtol=0)
    assert cam.next_frame() is None


class _OneFrame:
    def __init__(self, image):
        self.image = image

    def next_frame(self):
        image, self.image = self.image, None
        return None if image is None else providers.CameraDataFrame(0, 0.0, image)


def test_crop_transformer_power_of_two():
    """Frames and the model's size crop to multiples of 2^4."""
    assert crop_size_power_of_2(330, 250) == (320, 240)
    assert crop_size_power_of_2(320, 240) == (320, 240)
    calib = calibration.CameraCalibration("pinhole", (330, 250),
                                          np.asarray([300.0, 300.0, 165.0, 125.0]))
    image = (np.random.default_rng(5).random((250, 330)) * 255).astype(np.float32)
    cam = Camera("cam", _OneFrame(image), CameraSettings(
        calibration=calib, inverse_response=np.arange(256, dtype=np.float64)), device="cpu")
    frame = cam.next_frame()
    assert tuple(frame.image.shape) == (240, 320)
    np.testing.assert_allclose(frame.image.numpy(), image[:240, :320], rtol=1e-6)
    model = cam.camera_model()
    assert (model.width, model.height) == (320.0, 240.0) and model.fx == 300.0


def test_mask_pyramid_and_semantic_filter_match():
    rng = np.random.default_rng(6)
    mask = rng.random((34, 50)) > 0.2
    for a, b in zip(masks.mask_pyramid(torch.as_tensor(mask), 4),
                    jmasks.mask_pyramid(jnp.asarray(mask), 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sem = rng.integers(0, 10, (34, 50)).astype(np.uint8)
    for ids in ([7], (3, 9), ()):
        np.testing.assert_array_equal(
            masks.filter_semantic_objects(torch.as_tensor(mask), sem, ids).numpy(),
            np.asarray(jmasks.filter_semantic_objects(jnp.asarray(mask), sem, ids)))
    full = masks.load_mask(None, (50, 34), device="cpu")
    assert full.dtype == torch.bool and full.shape == (34, 50) and bool(full.all())


def _distorted(tag):
    if tag == "simple_radial":
        return jcal.CameraCalibration("simple_radial", (128.0, 96.0),
                                      np.asarray([80.0, 64.0, 48.0, -0.15, 0.01]))
    return jcal.CameraCalibration("tum_fov", (128.0, 96.0),
                                  np.asarray([70.0, 72.0, 63.5, 47.5, 0.9]))


@pytest.mark.parametrize("tag", ["simple_radial", "tum_fov"])
def test_build_remaps_matches_jax(tag):
    calib = _distorted(tag)
    jsrc = calib.camera_model(0, jnp.float64)
    port = undistorter.build_remaps(
        convert.camera_model(calib.model_type, calib.image_size, calib.intrinsics), "cpu")
    ref = jund.build_remaps(jsrc)
    assert tuple(port.target_model[:4]) == tuple(float(v) for v in ref.target_model[:4])
    h, w = 96, 128
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    rays = ref.target_model.unproject(jnp.asarray(np.stack([xs, ys], -1).reshape(-1, 2)))
    src = np.asarray(jsrc.project(rays)[0]).reshape(h, w, 2)
    assert port.map_x.dtype == torch.float64
    np.testing.assert_allclose(port.map_x.numpy(), src[..., 0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.map_y.numpy(), src[..., 1], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port.map_x.numpy().astype(np.float32), ref.map_x)
    np.testing.assert_array_equal(port.map_y.numpy().astype(np.float32), ref.map_y)


@pytest.mark.parametrize("tag", ["simple_radial", "tum_fov"])
def test_undistort_matches_cv2_remap(tag):
    calib = _distorted(tag)
    ref = jund.build_remaps(calib.camera_model(0, jnp.float64))
    port = undistorter.Undistorter(
        ref.target_model, torch.as_tensor(ref.map_x), torch.as_tensor(ref.map_y))
    rng = np.random.default_rng(8)
    image = cv2.GaussianBlur(rng.uniform(0, 255, (96, 128)).astype(np.float32), (5, 5), 1.5)
    out = port.undistort(torch.as_tensor(image))
    assert out.dtype == torch.float32
    expected = ref.undistort(image)
    grad = max(np.abs(np.diff(image, axis=0)).max(), np.abs(np.diff(image, axis=1)).max())
    np.testing.assert_allclose(out.numpy(), expected, atol=grad / 64 + 1e-4, rtol=0)
    # u8 frames remap as f32 of the same values
    u8 = image.astype(np.uint8)
    np.testing.assert_array_equal(port.undistort(torch.as_tensor(u8)).numpy(),
                                  port.undistort(torch.as_tensor(u8.astype(np.float32))).numpy())


def test_cv2_features_raise_without_cv2(dataset, monkeypatch):
    """Image decoding and the vignette file need cv2: without it they raise
    an ImportError naming cv2; the npy provider and the photometric
    calibration do not need it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    provider = providers.ImageFolderProvider(str(dataset / "images"))
    with pytest.raises(ImportError, match="cv2"):
        provider.next_frame()
    with pytest.raises(ImportError, match="cv2"):
        calibration.load_vignetting(str(dataset / "vignette.png"))
    frame = providers.NpyFolderProvider(str(dataset / "npy")).next_frame()
    assert frame.image.dtype == np.uint8
    assert calibration.load_photometric_calibration(str(dataset / "pcalib.txt")).shape == (256,)


def test_calibration_refuses_malformed_files(tmp_path):
    for text in ("fisheye\n640 480\n1 2 3 4\n", "pinhole\n640 480\n520 520 320\n",
                 "simple_radial\n640 480\n300 320 240 -0.05\n"):
        path = tmp_path / "calib.txt"
        path.write_text(text)
        with pytest.raises(ValueError):
            calibration.load_calibration(str(path))
