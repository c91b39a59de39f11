"""The port's TFRecord and `tf.train.Example` I/O
(`openvla_oft_tpu_torch/data/rlds/tfrecord.py`) against TensorFlow's:
files written by the port read back by `tf.data.TFRecordDataset` and files
written by `tf.io.TFRecordWriter` read by the port, record for record;
Example bytes parsed both ways against `tf.train.Example`, packed and
unpacked; the CRC-32C of the host library against its plain version and
the standard check values; a flipped byte or a truncated file raises.
TF is imported inside the tests; the CRC and corruption tests run without it.
"""

import struct

import numpy as np
import pytest

from openvla_oft_tpu_torch.data.rlds import tfrecord as R


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _records(rng, n=5):
    return [rng.integers(0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
            for _ in range(n)] + [b"", b"\xff" * 7]


def test_crc32c_check_values():
    for crc in (R.crc32c, R.crc32c_plain):
        assert crc(b"123456789") == 0xE3069283          # the CRC-32C check value
        assert crc(b"") == 0
        assert crc(bytes(32)) == 0x8A9136AA             # RFC 3720 B.4
        assert crc(bytes(range(32))) == 0x46DD794E
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 1000, 4099):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert R.crc32c(data) == R.crc32c_plain(data)


def test_port_writes_tf_reads(tf, tmp_path):
    records = _records(np.random.default_rng(1))
    path = str(tmp_path / "a.tfrecord")
    R.write_tfrecords(path, records)
    got = [r.numpy() for r in tf.data.TFRecordDataset(path)]
    assert got == records
    assert list(R.read_tfrecords(path)) == records


def test_tf_writes_port_reads(tf, tmp_path):
    records = _records(np.random.default_rng(2))
    path = str(tmp_path / "b.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
    assert list(R.read_tfrecords(path)) == records
    # the same bytes on disk as the port's writer
    path2 = str(tmp_path / "c.tfrecord")
    R.write_tfrecords(path2, records)
    assert open(path, "rb").read() == open(path2, "rb").read()


@pytest.mark.parametrize("where", ["length", "length_crc", "data", "data_crc"])
def test_flipped_byte_raises(tmp_path, where):
    path = tmp_path / "d.tfrecord"
    R.write_tfrecords(str(path), [b"hello world", b"second record"])
    raw = bytearray(path.read_bytes())
    offset = {"length": 0, "length_crc": 9, "data": 14, "data_crc": 12 + 11 + 1}[where]
    raw[offset] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupted|truncated"):
        list(R.read_tfrecords(str(path)))


def test_truncated_file_raises(tmp_path):
    path = tmp_path / "e.tfrecord"
    R.write_tfrecords(str(path), [b"a" * 100])
    path.write_bytes(path.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        list(R.read_tfrecords(str(path)))


def _tf_example(tf, feats):
    def feature(kind, values):
        if kind == "bytes":
            return tf.train.Feature(bytes_list=tf.train.BytesList(value=values))
        if kind == "float":
            return tf.train.Feature(float_list=tf.train.FloatList(value=values))
        return tf.train.Feature(int64_list=tf.train.Int64List(value=values))

    return tf.train.Example(features=tf.train.Features(
        feature={k: feature(*v) for k, v in feats.items()}))


FEATURES = {
    "steps/observation/image_primary": ("bytes", [b"\xff\xd8jpeg one", b"", b"\x00" * 300]),
    "steps/action": ("float", [0.5, -1.25, 3e-8, 1e30, -0.0]),
    "steps/observation/proprio": ("float", []),
    "language_instruction": ("bytes", ["pick up the black bowl".encode()]),
    "counts": ("int64", [0, 1, -1, 2 ** 40, -(2 ** 62), 127, 128]),
}


def _check(parsed, feats):
    assert sorted(parsed) == sorted(feats)
    for name, (kind, values) in feats.items():
        got_kind, got = parsed[name]
        if kind == "bytes":
            assert got_kind == "bytes" and list(got) == list(values), name
        elif len(values):
            assert got_kind == kind, name
            want = np.asarray(values, np.float32 if kind == "float" else np.int64)
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert len(got) == 0, name


def test_example_parse_both_ways(tf):
    # TF serializes, the port parses
    _check(R.parse_example(_tf_example(tf, FEATURES).SerializeToString()), FEATURES)
    # the port serializes, TF parses
    ex = tf.train.Example.FromString(R.serialize_example(FEATURES))
    for name, (kind, values) in FEATURES.items():
        f = ex.features.feature[name]
        got = {"bytes": f.bytes_list.value, "float": f.float_list.value,
               "int64": f.int64_list.value}[kind]
        np.testing.assert_array_equal(
            np.asarray(list(got), dtype=object if kind == "bytes" else None),
            np.asarray(values, dtype=object if kind == "bytes" else
                       np.float32 if kind == "float" else np.int64), err_msg=name)
    # and through tf.io.parse_single_example on the episode spec
    spec = {"steps/action": tf.io.VarLenFeature(tf.float32),
            "language_instruction": tf.io.FixedLenFeature([], tf.string)}
    parsed = tf.io.parse_single_example(R.serialize_example(FEATURES), spec)
    np.testing.assert_array_equal(tf.sparse.to_dense(parsed["steps/action"]).numpy(),
                                  np.asarray(FEATURES["steps/action"][1], np.float32))
    assert parsed["language_instruction"].numpy() == FEATURES["language_instruction"][1][0]


def _varint(n):
    return R._varint(n)


def test_unpacked_repeated_fields_parse():
    """A FloatList / Int64List written unpacked (one tag a value), as older
    protobuf writers may."""
    floats = b"".join(b"\x0d" + struct.pack("<f", v) for v in (1.5, -2.0))
    ints = b"".join(b"\x08" + _varint(v) for v in (3, -4))
    feature_f = R._field(2, floats)
    feature_i = R._field(3, ints)
    entries = (R._field(1, R._field(1, b"f") + R._field(2, feature_f))
               + R._field(1, R._field(1, b"i") + R._field(2, feature_i)))
    parsed = R.parse_example(R._field(1, entries))
    np.testing.assert_array_equal(parsed["f"][1], np.asarray([1.5, -2.0], np.float32))
    np.testing.assert_array_equal(parsed["i"][1], np.asarray([3, -4], np.int64))


def test_unpacked_fields_against_tf(tf):
    floats = b"".join(b"\x0d" + struct.pack("<f", v) for v in (0.25, 8.0))
    entries = R._field(1, R._field(1, b"x") + R._field(2, R._field(2, floats)))
    data = R._field(1, entries)
    assert list(tf.train.Example.FromString(data).features.feature["x"].float_list.value) == \
        [0.25, 8.0]
    np.testing.assert_array_equal(R.parse_example(data)["x"][1], [0.25, 8.0])
