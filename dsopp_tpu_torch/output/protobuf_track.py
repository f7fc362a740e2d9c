"""Wire-compatible ``track.bin`` writer and reader (counterpart of
``dsopp_tpu/output/protobuf_track.py``, a numpy copy of it that reads the
port's ``Window``).

The reference persists a track as a custom-framed protobuf stream
(track_storage.cpp):

    u64-LE   number of keyframes
    per keyframe:  u32-LE size + Keyframe message
    then u32-LE-size-prefixed: Connections, GnssTrack, ECEFPoses,
    SanityCheckResults, AgentSettings

The messages follow the reference's proto3 schema, written by hand here
(varints, fixed64 doubles, packed doubles, length-delimited messages), so a
file written here opens in the reference viewer, pydsopp and the JAX
package, with no protobuf dependency.  SE3 poses use the Sophus parameter
layout (qx, qy, qz, qw, tx, ty, tz).
"""

from __future__ import annotations

import struct

import numpy as np

from dsopp_tpu_torch.output.tum import _matrix_to_quat, _quat_to_matrix

# ---------------------------------------------------------------------------
# proto3 wire primitives
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    if value == 0:
        return b""
    return _tag(field, 0) + _varint(int(value))


def field_double(field: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return _tag(field, 1) + struct.pack("<d", float(value))


def field_bytes(field: int, data: bytes) -> bytes:
    if not data:
        return b""
    return _tag(field, 2) + _varint(len(data)) + data


def field_message(field: int, data: bytes) -> bytes:
    """Sub-message: always emitted (presence matters for repeated fields)."""
    return _tag(field, 2) + _varint(len(data)) + data


def field_packed_doubles(field: int, values) -> bytes:
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return b""
    payload = values.tobytes()
    return _tag(field, 2) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# message builders (src/storage/proto/*.proto)
# ---------------------------------------------------------------------------


def _landmark(uv, direction, idepth, variance, baseline, semantic=0) -> bytes:
    return b"".join([
        field_double(1, uv[0]),
        field_double(2, uv[1]),
        field_double(3, direction[0]),
        field_double(4, direction[1]),
        field_double(5, direction[2]),
        field_double(6, idepth),
        field_double(7, baseline),
        field_varint(8, semantic),
        field_double(9, variance),
    ])


def _landmarks_frame(sensor_id, landmarks: list) -> bytes:
    return b"".join(
        [field_varint(1, sensor_id)]
        + [field_message(2, lm) for lm in landmarks])


def _tracking_frame(timestamp_ns, t_keyframe_agent7, affine, exposure) -> bytes:
    return b"".join([
        field_varint(1, timestamp_ns),
        field_packed_doubles(2, t_keyframe_agent7),
        field_packed_doubles(3, affine),
        field_double(5, exposure),
    ])


def _keyframe(frame_id, keyframe_id, timestamp_ns, t_world_agent7, affine,
              exposure, landmarks_frames, tracking_frames) -> bytes:
    return b"".join(
        [
            field_varint(1, frame_id),
            field_varint(2, timestamp_ns),
            field_packed_doubles(3, t_world_agent7),
            field_packed_doubles(4, affine),
        ]
        + [field_message(5, lf) for lf in landmarks_frames]
        + [field_message(6, tf) for tf in tracking_frames]
        + [
            field_varint(8, keyframe_id),
            field_double(9, exposure),
        ])


def _camera_settings(intrinsics, image_size, model_type: int,
                     photometric=None, shutter_time=0.0) -> bytes:
    return b"".join([
        field_packed_doubles(1, intrinsics),
        field_packed_doubles(2, photometric if photometric is not None else []),
        field_varint(5, model_type),
        field_packed_doubles(6, image_size),
        field_double(7, shutter_time),
    ])


def _agent_settings(camera_settings_by_id: dict) -> bytes:
    out = []
    for sensor_id, cs in camera_settings_by_id.items():
        entry = field_varint(1, sensor_id) + field_message(2, cs)
        out.append(field_message(1, entry))
    return b"".join(out)


def _connection(ref_kf, ref_sensor, tgt_kf, tgt_sensor, covariance=None) -> bytes:
    return b"".join([
        field_varint(1, ref_kf),
        field_varint(2, ref_sensor),
        field_varint(3, tgt_kf),
        field_varint(4, tgt_sensor),
        field_packed_doubles(5, covariance if covariance is not None else []),
    ])


def _connections(conns: list) -> bytes:
    return b"".join(field_message(1, c) for c in conns)


def _sanity_check_results(results: dict) -> bytes:
    """SanityCheckResults (sanity_check_results.proto): map<uint64, enum> —
    wire form is repeated entry messages {1: key, 2: value}."""
    out = []
    for frame_index, status in sorted(results.items()):
        entry = field_varint(1, int(frame_index)) + field_varint(2, int(status))
        out.append(field_message(1, entry))
    return b"".join(out)


# ---------------------------------------------------------------------------
# SE3 helpers
# ---------------------------------------------------------------------------


def _mat_to_sophus7(mat) -> np.ndarray:
    """4x4 → [qx, qy, qz, qw, tx, ty, tz] (Sophus data layout)."""
    q = _matrix_to_quat(np.asarray(mat)[:3, :3])  # (w, x, y, z)
    t = np.asarray(mat)[:3, 3]
    return np.asarray([q[1], q[2], q[3], q[0], t[0], t[1], t[2]])


def _sophus7_to_mat(p) -> np.ndarray:
    mat = np.eye(4)
    mat[:3, :3] = _quat_to_matrix(p[3], p[0], p[1], p[2])
    mat[:3, 3] = p[4:7]
    return mat


# ---------------------------------------------------------------------------
# top-level save (track_storage.cpp framing)
# ---------------------------------------------------------------------------


def save_track_bin(path, track, window=None, camera=None, model=None,
                   sensor_id=0, sanity_results=None):
    """Write a reference-compatible ``track.bin``.

    ``track``: OdometryTrack; ``window``: the live PBA window (the port's
    ``Window``, on any device); ``camera``: the
    Pinhole model for landmark directions; ``model``: optional
    CameraCalibration for AgentSettings; ``sanity_results``: optional
    {keyframe index → SanityCheckStatus} map (sanity_check_results.proto).
    """
    keyframes = []
    connections = [
        _connection(ref, sensor_id, tgt, sensor_id,
                    np.asarray(cov, np.float64).reshape(-1))
        for (ref, tgt), cov in getattr(track, "connections", {}).items()
    ]

    def unproject(uv):
        fx = float(camera.fx)
        fy = float(camera.fy)
        cx = float(camera.cx)
        cy = float(camera.cy)
        return np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                         np.ones(len(uv))], axis=1)

    def add(frame_id, kf_index, ts, t_wc, affine, exposure, uv, idep,
            valid, baseline, attached, semantic=None):
        dirs = unproject(np.asarray(uv)) if camera is not None else \
            np.zeros((len(uv), 3))
        lms = [
            _landmark(uv[i], dirs[i], float(idep[i]), 0.0,
                      float(baseline[i]) if baseline is not None else 0.0,
                      semantic=0 if semantic is None else int(semantic[i]))
            for i in range(len(uv)) if valid[i]
        ]
        tfs = [
            _tracking_frame(int(a.timestamp * 1e9),
                            _mat_to_sophus7(a.t_keyframe_frame),
                            np.asarray(a.affine), a.exposure)
            for a in attached
        ]
        keyframes.append(_keyframe(
            frame_id, kf_index, int(ts * 1e9), _mat_to_sophus7(t_wc),
            np.asarray(affine), exposure,
            [_landmarks_frame(sensor_id, lms)], tfs))

    kf_index = 0
    for kf in track.marginalized:
        add(kf.frame_id, kf_index, kf.timestamp, kf.t_wc, kf.affine,
            kf.exposure, kf.lm_uv, kf.lm_idepth,
            kf.lm_valid & ~kf.lm_outlier, kf.lm_baseline, kf.attached,
            semantic=getattr(kf, "lm_semantic", None))
        kf_index += 1

    if window is not None:
        # the window's tensors, copied to the host once
        mats = window.poses().matrix().cpu().numpy().astype(np.float64)
        ids = window.frame_id.cpu().numpy()
        affine = window.affine().cpu().numpy()
        exposure = window.exposure.cpu().numpy()
        uv = window.lm_uv.cpu().numpy()
        idepth = window.lm_idepth.cpu().numpy()
        live = (window.lm_valid & ~window.lm_outlier).cpu().numpy()
        baseline = window.lm_baseline.cpu().numpy()
        for pos in range(int(window.frame_valid.sum())):
            fid = int(ids[pos])
            add(fid, kf_index, track.keyframe_timestamps.get(fid, 0.0), mats[pos],
                affine[pos], float(exposure[pos]), uv[pos], idepth[pos], live[pos],
                baseline[pos], track.attached.get(fid, []))
            kf_index += 1

    agent = b""
    if model is not None:
        model_type = 0 if model.model_type == "pinhole" else 1
        agent = _agent_settings({sensor_id: _camera_settings(
            model.intrinsics, model.image_size, model_type,
            shutter_time=model.shutter_time)})

    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(keyframes)))
        for kf in keyframes:
            f.write(struct.pack("<I", len(kf)))
            f.write(kf)
        sanity = (_sanity_check_results(sanity_results)
                  if sanity_results else b"")
        for blob in (_connections(connections), b"", b"", sanity, agent):
            f.write(struct.pack("<I", len(blob)))
            f.write(blob)


# ---------------------------------------------------------------------------
# reader (for round-trip tests; tolerant skipping parser)
# ---------------------------------------------------------------------------


def _parse_fields(data):
    """Yield (field, wire, value) from a message buffer."""
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value = struct.unpack_from("<d", data, i)[0]
            i += 8
        elif wire == 2:
            length, i = _read_varint(data, i)
            value = data[i:i + length]
            i += length
        elif wire == 5:
            value = struct.unpack_from("<f", data, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(data, i):
    shift = 0
    value = 0
    while True:
        b = data[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7


def _doubles(buf) -> np.ndarray:
    return np.frombuffer(buf, np.float64)


def load_track_bin(path):
    """Parse a track.bin → dict (keyframes with poses/landmarks/attached)."""
    with open(path, "rb") as f:
        data = f.read()
    n_frames = struct.unpack_from("<Q", data, 0)[0]
    off = 8
    keyframes = []
    for _ in range(n_frames):
        size = struct.unpack_from("<I", data, off)[0]
        off += 4
        msg = data[off:off + size]
        off += size
        # proto3: absent scalar fields mean their default value
        kf = {"landmarks": [], "attached": [], "affine": [],
              "t_world_agent": None, "frame_id": 0, "keyframe_id": 0,
              "timestamp": 0.0, "exposure": 0.0}
        for field, wire, value in _parse_fields(msg):
            if field == 1:
                kf["frame_id"] = value
            elif field == 2:
                kf["timestamp"] = value / 1e9
            elif field == 3:
                kf["t_world_agent"] = _sophus7_to_mat(_doubles(value))
            elif field == 4:
                kf["affine"] = _doubles(value)
            elif field == 5:
                sensor, lms = 0, []
                for f2, w2, v2 in _parse_fields(value):
                    if f2 == 1:
                        sensor = v2
                    elif f2 == 2:
                        lm = {}
                        for f3, w3, v3 in _parse_fields(v2):
                            lm[f3] = v3
                        lms.append({
                            "uv": (lm.get(1, 0.0), lm.get(2, 0.0)),
                            "direction": (lm.get(3, 0.0), lm.get(4, 0.0),
                                          lm.get(5, 0.0)),
                            "idepth": lm.get(6, 0.0),
                            "baseline": lm.get(7, 0.0),
                            "semantic": lm.get(8, 0),
                            "variance": lm.get(9, 0.0),
                        })
                kf["landmarks"].append({"sensor_id": sensor, "points": lms})
            elif field == 6:
                tf = {}
                for f2, w2, v2 in _parse_fields(value):
                    if f2 == 1:
                        tf["timestamp"] = v2 / 1e9
                    elif f2 == 2:
                        tf["t_keyframe_agent"] = _sophus7_to_mat(_doubles(v2))
                    elif f2 == 5:
                        tf["exposure"] = v2
                kf["attached"].append(tf)
            elif field == 8:
                kf["keyframe_id"] = value
            elif field == 9:
                kf["exposure"] = value
        keyframes.append(kf)

    # tail sections (track_storage.cpp:55-60): connections, gnss, ecef,
    # sanity results, agent settings — each u32-size-prefixed
    sections = []
    while off + 4 <= len(data):
        size = struct.unpack_from("<I", data, off)[0]
        off += 4
        sections.append(data[off:off + size])
        off += size
    sanity = {}
    if len(sections) >= 4 and sections[3]:
        for field, wire, value in _parse_fields(sections[3]):
            if field == 1:
                entry = {1: 0, 2: 0}
                for f2, _w2, v2 in _parse_fields(value):
                    entry[f2] = v2
                sanity[int(entry[1])] = int(entry[2])
    return {"keyframes": keyframes, "sanity_check_results": sanity}
