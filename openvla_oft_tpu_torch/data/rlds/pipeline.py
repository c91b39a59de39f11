"""RLDS episode pipeline on the host, without TensorFlow: the port of
`openvla_oft_tpu/data/rlds/pipeline.py` (its `make_rlds_iterator`; the
reference `prismatic/vla/datasets/rlds/dataset.py:40-589`).

Episodes come from TFRecord shards (`<root>/<name>/*.tfrecord*`), one
serialized `tf.train.Example` an episode, read by `data/rlds/tfrecord.py`:

  steps/observation/image_primary : bytes list (JPEG per step)
  steps/observation/wrist_image   : bytes list (optional)
  steps/observation/proprio       : float list (T * proprio_dim)
  steps/action                    : float list (T * action_dim)
  language_instruction            : bytes

`make_interleaved_iterator` mixes several such datasets by weight (the JAX
`make_interleaved_iterator`, reference `make_interleaved_dataset`).
TFDS-format shards are converted to this format first
(`data/rlds/tfds_format.py::convert_tfds_to_native`).

Stages, as the JAX graph runs them: records in file order (`read_parallelism`
files interleaved a record at a time; the port reads every file), in train
mode repeated and shuffled over min(64, max(4 * files, 8)) records; each
episode parsed, standardized by the OXE registry (`"auto"`), its actions
normalized (the registry's gripper mask in the statistics), chunked
(`eff = T - future`, indices capped at T - 1) and its proprio normalized;
the frames of `cycle_length` episodes interleaved a frame at a time, an
exhausted episode's slot going to the next episode; in train mode a
shuffle buffer over the still JPEG-encoded frames; then JPEG decoding
(`processing/jpeg_decode.py`, the host library) and augmentation
(`data/rlds/augment.py`) in a pool of threads, in order.

At `train=False` the frame stream is the JAX pipeline's, bit for bit (one
shard, or `read_parallelism=1`: TF interleaves shards by its CPU count). In
train mode the shuffles, goal relabels and augmentation draws come from the
port's own seeded numpy generators: the same seed gives the same stream,
but not TF's (its stateless RNG and FarmHash seeds are its own).
"""

from __future__ import annotations

import collections
import glob
import itertools
import json
import os
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from openvla_oft_tpu_torch.constants import NormalizationType, PlatformSpec
from openvla_oft_tpu_torch.data.rlds import tfrecord
from openvla_oft_tpu_torch.data.transforms import (compute_dataset_statistics,
                                                   load_dataset_statistics,
                                                   save_dataset_statistics)

_IMAGE = "steps/observation/image_primary"
_WRIST = "steps/observation/wrist_image"
_PROPRIO = "steps/observation/proprio"
_ACTION = "steps/action"
_LANG = "language_instruction"


def write_episode_tfrecords(out_dir: str, episodes: List[Dict[str, Any]],
                            shard_size: int = 64) -> List[str]:
    """Write native-format episode shards: each episode's `images` (and
    `wrist_images`) as JPEG bytes, `actions` (T, A), `proprio` (T, P) and
    `language_instruction` (str)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for si in range(0, len(episodes), shard_size):
        path = os.path.join(out_dir, f"episodes-{si // shard_size:05d}.tfrecord")
        records = []
        for ep in episodes[si:si + shard_size]:
            feats = {
                _IMAGE: ("bytes", ep["images"]),
                _ACTION: ("float", np.asarray(ep["actions"], np.float32).reshape(-1)),
                _PROPRIO: ("float", np.asarray(ep.get("proprio", []), np.float32).reshape(-1)),
                _LANG: ("bytes", [ep["language_instruction"].encode()]),
            }
            if "wrist_images" in ep:
                feats[_WRIST] = ("bytes", ep["wrist_images"])
            records.append(tfrecord.serialize_example(feats))
        tfrecord.write_tfrecords(path, records)
        paths.append(path)
    return paths


def _feature(ex: Dict, name: str, kind: str):
    if name not in ex:
        raise ValueError(f"episode record has no feature {name!r}")
    got, values = ex[name]
    if got != kind and len(values):
        raise ValueError(f"feature {name!r} holds a {got} list, expected {kind}")
    return values if len(values) or kind != "float" else np.zeros(0, np.float32)


def _parse_episode(record: bytes, platform: PlatformSpec, has_wrist: bool) -> Dict:
    """A serialized episode -> {"images": object array of JPEG bytes,
    "actions" (T, A), "proprio" (T, P) float32, "language_instruction"
    bytes[, "wrist_images"]} (`tf.io.parse_single_example` on the spec)."""
    ex = tfrecord.parse_example(record)
    lang = _feature(ex, _LANG, "bytes")
    if len(lang) != 1:
        raise ValueError(f"{_LANG!r} must hold one value, got {len(lang)}")
    ep = {"images": np.asarray(list(_feature(ex, _IMAGE, "bytes")) or [], dtype=object),
          "actions": np.asarray(_feature(ex, _ACTION, "float")).reshape(-1, platform.action_dim),
          "proprio": np.asarray(_feature(ex, _PROPRIO, "float")).reshape(-1, platform.proprio_dim),
          "language_instruction": bytes(lang[0])}
    if has_wrist:
        ep["wrist_images"] = np.asarray(list(_feature(ex, _WRIST, "bytes")), dtype=object)
    return ep


def _normalize(x: np.ndarray, metadata: Dict, norm_type: NormalizationType) -> np.ndarray:
    """The JAX graph's `_normalize_tf` in float32 numpy: bounds (min/max, or
    q01/q99 for any other type) to [-1, 1] with clipping under the mask,
    degenerate dims (min == max) to 0."""
    x = np.asarray(x, np.float32)
    mask = np.asarray(metadata.get("mask", np.ones_like(metadata["min"], bool)), bool)
    keys = ("min", "max") if norm_type == NormalizationType.BOUNDS else ("q01", "q99")
    low, high = (np.asarray(metadata[k], np.float32) for k in keys)
    out = np.where(mask, np.clip(2 * (x - low) / (high - low + np.float32(1e-8)) - 1, -1, 1), x)
    zeros = np.asarray(metadata["min"]) == np.asarray(metadata["max"])
    return np.where(zeros, np.zeros_like(out), out).astype(np.float32)


_WARNED_PROPRIO_KEYS: set = set()


def _assemble_proprio(obs: Dict, name: str, t: int) -> Optional[np.ndarray]:
    """The registry's state_obs_keys concatenated into the proprio vector,
    None entries a zero column (reference rlds/dataset.py obs remapping; the
    one copy, shared by the standardize path here and the TFDS conversion,
    `data/rlds/tfds_format.py`). Columns are cut to `t`, so truncating
    transforms stay aligned. obs["proprio"] (or None) where a key is absent
    or none are registered."""
    from openvla_oft_tpu_torch.data.rlds.oxe import OXE_DATASET_CONFIGS

    cfg = OXE_DATASET_CONFIGS.get(name)
    if cfg is None or not cfg.state_obs_keys:
        return obs.get("proprio")
    cols = []
    for key in cfg.state_obs_keys:
        if key is None:
            cols.append(np.zeros((t, 1), np.float32))
        elif key in obs:
            cols.append(np.asarray(obs[key], np.float32)[:t].reshape(t, -1))
        else:
            if (name, key) not in _WARNED_PROPRIO_KEYS:
                _WARNED_PROPRIO_KEYS.add((name, key))
                print(f"[rlds] {name}: state_obs_key {key!r} missing after "
                      f"standardization — falling back to the episode's raw "
                      f"proprio stream", file=sys.stderr)
            return obs.get("proprio")
    return np.concatenate(cols, axis=1)


def _standardize_episode_np(ep_np: Dict, name: str, standardize_fn: Callable,
                            platform: PlatformSpec) -> Dict:
    """An OXE standardization transform on a parsed episode: the RLDS
    trajectory layout the registry expects (the raw `state` key, one
    instruction a step, the images riding along so truncating transforms
    keep them aligned), then proprio reassembled from `state_obs_keys`."""
    t = len(ep_np["actions"])
    lang = ep_np["language_instruction"]
    lang_steps = np.asarray([lang] * t) if np.ndim(lang) == 0 else lang
    traj = {
        "action": np.asarray(ep_np["actions"], np.float32),
        "observation": {"state": np.asarray(ep_np["proprio"], np.float32),
                        "proprio": np.asarray(ep_np["proprio"], np.float32),
                        "image_primary": np.asarray(ep_np["images"]),
                        **({"image_wrist": np.asarray(ep_np["wrist_images"])}
                           if "wrist_images" in ep_np else {})},
        "language_instruction": lang_steps,
    }
    out = standardize_fn(traj)
    actions = np.asarray(out["action"], np.float32)
    t_out = len(actions)
    obs = out["observation"]
    proprio = _assemble_proprio(obs, name, t_out)
    if proprio is None:
        proprio = ep_np["proprio"]
    proprio = np.asarray(proprio, np.float32)[:t_out]
    out_lang = out.get("language_instruction", lang_steps)
    result = {
        "images": np.asarray(obs["image_primary"])[:t_out],
        "actions": actions,
        "proprio": proprio,
        "language_instruction": out_lang[0] if np.ndim(out_lang) else out_lang,
    }
    if "image_wrist" in obs:
        result["wrist_images"] = np.asarray(obs["image_wrist"])[:t_out]
    return result


def _resolve_standardize_fn(root: str, name: str, standardize_fn):
    """The "auto" sentinel -> the OXE registry's transform for `name`, or
    None where the data was standardized at conversion time (a
    native_format.json marker) or the name is unregistered."""
    if standardize_fn != "auto":
        return standardize_fn
    marker = os.path.join(root, name, "native_format.json")
    if os.path.exists(marker):
        with open(marker) as f:
            if json.load(f).get("standardized"):
                return None
    from openvla_oft_tpu_torch.data.rlds.oxe import OXE_STANDARDIZATION_TRANSFORMS

    return OXE_STANDARDIZATION_TRANSFORMS.get(name)


def _process_shard(index: Optional[int], count: Optional[int]) -> Tuple[int, int]:
    """(index, count) of the process reading, by default from the process
    group (0 of 1 without one)."""
    if count is None:
        from openvla_oft_tpu_torch.parallel.mesh import process_count, process_index

        index, count = process_index(), process_count()
    return (index or 0), count


def _files(root: str, name: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(root, name, "*.tfrecord*")))
    if not files:
        raise FileNotFoundError(f"no tfrecords under {os.path.join(root, name)}")
    return files


def compute_stats_from_tfrecords(root: str, name: str, platform: PlatformSpec,
                                 max_episodes: int = 1000,
                                 standardize_fn: Optional[Callable] = None,
                                 has_wrist: bool = False) -> Dict:
    """Statistics over the first `max_episodes` standardized episodes, in
    file order, with the transform's name and, for a registered dataset, its
    action normalization mask (the absolute gripper exempt)."""
    acts, props, n_ep = [], [], 0
    for rec in _interleave([tfrecord.read_tfrecords(f) for f in _files(root, name)], 1):
        if n_ep >= max_episodes:
            break
        ep = _parse_episode(rec, platform, has_wrist=has_wrist)
        if standardize_fn is not None:
            ep = _standardize_episode_np(ep, name, standardize_fn, platform)
        acts.append(np.asarray(ep["actions"]))
        if len(np.asarray(ep["proprio"])):
            props.append(np.asarray(ep["proprio"]))
        n_ep += 1
    stats = compute_dataset_statistics(np.concatenate(acts),
                                       np.concatenate(props) if props else None,
                                       num_trajectories=n_ep)
    if standardize_fn is not None:
        stats["transform"] = getattr(standardize_fn, "__name__", "custom")
    from openvla_oft_tpu_torch.data.rlds.oxe.materialize import dataset_action_normalization_mask

    mask = dataset_action_normalization_mask(name)
    if mask is not None and len(mask) == len(stats["action"]["min"]):
        stats["action"]["mask"] = mask
    return stats


def dataset_statistics(root: str, name: str, platform: PlatformSpec,
                       standardize_fn) -> Dict:
    """The dataset's `dataset_statistics.json`, recomputed and rewritten
    when missing or computed under another standardization."""
    fn_name = getattr(standardize_fn, "__name__", "custom") if standardize_fn else None
    path = os.path.join(root, name, "dataset_statistics.json")
    if os.path.exists(path):
        stats = load_dataset_statistics(path)
        if stats.get("transform") == fn_name:
            return stats
    stats = compute_stats_from_tfrecords(root, name, platform, standardize_fn=standardize_fn)
    save_dataset_statistics(stats, os.path.join(root, name))
    return stats


# === Generic stream stages, with tf.data's semantics ===
def _interleave(sources: Iterable[Iterable], cycle_length: int) -> Iterator:
    """tf.data `interleave(cycle_length, block_length=1)`, sequential: a
    round robin over `cycle_length` open iterators; an exhausted one leaves
    its slot empty until the cycle comes back to it, which then opens the
    next source there."""
    sources = iter(sources)
    slots: List[Optional[Iterator]] = [None] * max(int(cycle_length), 1)
    i, n_open, end = 0, 0, False
    while not end or n_open:
        if slots[i] is not None:
            try:
                item = next(slots[i])
            except StopIteration:
                slots[i] = None
                n_open -= 1
                i = (i + 1) % len(slots)
                continue
            i = (i + 1) % len(slots)
            yield item
        elif not end:
            try:
                slots[i] = iter(next(sources))
                n_open += 1
            except StopIteration:
                end = True
        else:
            i = (i + 1) % len(slots)


def _shuffle(items: Iterable, size: int, rng: np.random.Generator) -> Iterator:
    """A shuffle buffer of `size`: filled, then each output drawn uniformly
    from it and its place taken by the next input; drained at the end."""
    buf: List = []
    for item in items:
        if len(buf) < size:
            buf.append(item)
            continue
        j = int(rng.integers(len(buf)))
        out, buf[j] = buf[j], item
        yield out
    while buf:
        j = int(rng.integers(len(buf)))
        buf[j], buf[-1] = buf[-1], buf[j]
        yield buf.pop()


def _ordered_map(fn: Callable, items: Iterable, threads: int) -> Iterator:
    """fn over `items` in a pool of `threads`, outputs in input order, at
    most 2 x threads in flight. The pool stops with the generator."""
    pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="rlds-decode")
    pending: collections.deque = collections.deque()
    try:
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * threads:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for f in pending:        # every submitted future not yet returned
            f.cancel()
        pool.shutdown(wait=False)


def _repeat(make: Callable[[], Iterable]) -> Iterator:
    while True:
        yield from make()


# === The frame stream ===
def _frame_seed(frame: Dict) -> Tuple[int, int]:
    """A frame's augmentation seed from its instruction and action chunk
    (the JAX graph's recipe with CRC-32 in place of FarmHash)."""
    a = zlib.crc32(frame["language_instruction"]) % (1 << 30)
    b = int(np.sum((np.asarray(frame["action_chunk"], np.float32) * np.float32(1e4))
                   .astype(np.int64))) % (1 << 30)
    return a, b


def _build_encoded_frames(root: str, name: str, platform: PlatformSpec, train: bool = True,
                          seed: int = 0, standardize_fn="auto", num_images: int = 1,
                          goal_relabeling_strategy: Optional[str] = None,
                          read_parallelism: Optional[int] = None,
                          cycle_length: int = 4, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> Tuple[Iterator[Dict], Dict]:
    """The frame stream up to (and without) decoding, images still
    JPEG-encoded, and the dataset's statistics. With `process_count` > 1
    (by default the process group's size) and at least that many episode
    files, process `process_index` reads `files[index::count]` and shuffles
    with seed + index (JAX pipeline.py:315-332)."""
    if goal_relabeling_strategy not in (None, "uniform"):
        raise ValueError(f"unknown goal_relabeling_strategy {goal_relabeling_strategy!r}")
    standardize_fn = _resolve_standardize_fn(root, name, standardize_fn)
    stats = dataset_statistics(root, name, platform, standardize_fn)
    norm_type = platform.norm_type
    future = platform.num_actions_chunk - 1
    files = _files(root, name)
    proc, n_proc = _process_shard(process_index, process_count)
    if n_proc > 1 and len(files) >= n_proc:
        files = files[proc::n_proc]
        print(f"[rlds] process {proc}/{n_proc} reads {len(files)} of the episode "
              f"shards for {name}")
    seed = seed + proc
    has_wrist = num_images > 1
    reads = max(int(read_parallelism or 1), 1)

    def records():
        return _interleave([tfrecord.read_tfrecords(f) for f in files], reads)

    stream = records()
    if train:
        stream = _shuffle(_repeat(records), min(64, max(len(files) * 4, 8)),
                          np.random.default_rng(seed))

    def to_frames(record: bytes) -> Iterator[Dict]:
        ep = _parse_episode(record, platform, has_wrist=has_wrist)
        if standardize_fn is not None:
            ep = _standardize_episode_np(ep, name, standardize_fn, platform)
        actions = _normalize(ep["actions"], stats["action"], norm_type)
        t = len(actions)
        eff = max(t - future, 0)
        idx = np.minimum(np.arange(eff)[:, None] + np.arange(future + 1)[None, :], t - 1)
        chunks = actions[idx]
        proprio = ep["proprio"]
        if stats.get("proprio"):
            proprio = _normalize(proprio, stats["proprio"], norm_type)
        lang = ep["language_instruction"]
        lang = lang if isinstance(lang, bytes) else str(lang).encode()
        goal_idx = None
        if goal_relabeling_strategy == "uniform":
            # hindsight goal t' ~ Uniform[t, T) per frame, kept encoded
            u = np.random.default_rng([seed, zlib.crc32(lang)]).random(eff, dtype=np.float32)
            lo = np.arange(eff)
            goal_idx = np.minimum(lo + (u * (t - lo).astype(np.float32)).astype(np.int64), t - 1)
        for i in range(eff):
            frame = {"image_primary": ep["images"][i], "action_chunk": chunks[i],
                     "language_instruction": lang, "dataset_name": name,
                     "proprio": proprio[i]}
            if has_wrist:
                frame["image_wrist"] = ep["wrist_images"][i]
            if goal_idx is not None:
                frame["goal_image"] = ep["images"][goal_idx[i]]
            yield frame

    return _interleave((to_frames(r) for r in stream), cycle_length), stats


def _decode_frame(frame: Dict, image_aug: bool, train: bool, task_augment_prob: float) -> Dict:
    """JPEG decode (the host library) and, in train mode, augmentation with
    the frame's own draws; the wrist camera's seed is offset by [16, 0]."""
    from openvla_oft_tpu_torch.data.rlds.augment import augment_image, draw_augmentation
    from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg

    frame = dict(frame)
    a, b = _frame_seed(frame) if train else (0, 0)
    for key, offset in (("image_primary", 0), ("image_wrist", 16)):
        if key not in frame:
            continue
        img = decode_jpeg(frame[key])
        if image_aug and train:
            img = augment_image(img, draw_augmentation(np.random.default_rng([a + offset, b]),
                                                       *img.shape[:2]))
        frame[key] = img
    if task_augment_prob > 0 and train and "goal_image" in frame:
        # modality dropout (reference task_augmentation.py): keep the image
        # goal XOR the language
        u = np.random.default_rng([a + 32, b]).random(2)
        if u[0] < task_augment_prob:
            if u[1] < 0.5:
                frame["language_instruction"] = b""
            else:
                frame["goal_image"] = b""
    return frame


def _wrap_frame_iterator(frames: Iterable[Dict], batch_transform) -> Iterator:
    """Decoded frames -> the RLDS batch layout -> `batch_transform`."""
    for frame in frames:
        yield batch_transform({
            "observation": {
                "image_primary": frame["image_primary"],
                **({"image_wrist": frame["image_wrist"]} if "image_wrist" in frame else {}),
                **({"proprio": frame["proprio"]} if "proprio" in frame else {}),
            },
            "task": {"language_instruction": frame["language_instruction"],
                     **({"image_primary": frame["goal_image"]} if "goal_image" in frame else {})},
            "action": frame["action_chunk"],
            "dataset_name": frame["dataset_name"],
        })


def make_rlds_iterator(
    root: str,
    name: str,
    batch_transform,
    platform: PlatformSpec,
    shuffle_buffer_size: int = 10_000,
    image_aug: bool = True,
    train: bool = True,
    seed: int = 0,
    standardize_fn="auto",
    num_images: int = 1,
    goal_relabeling_strategy: Optional[str] = None,
    task_augment_prob: float = 0.0,
    read_parallelism: Optional[int] = None,
    transform_parallelism: Optional[int] = None,
    decode_parallelism: Optional[int] = None,
    cycle_length: int = 4,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[Iterator[Dict[str, np.ndarray]], Dict]:
    """The frame iterator (through `batch_transform`) and {name: stats},
    with the JAX function's signature. `read_parallelism`: shards
    interleaved a record at a time (default 1); `decode_parallelism`:
    decode and augmentation threads (default the CPU count, at most 8);
    `transform_parallelism` is accepted for the signature (episodes are
    parsed in the consumer's thread). Train mode repeats forever; at
    `train=False` one pass. `process_index` / `process_count`: this
    process's shard of the episode files (`_build_encoded_frames`; by
    default the process group's rank and size)."""
    del transform_parallelism
    frames, stats = _build_encoded_frames(
        root, name, platform, train=train, seed=seed, standardize_fn=standardize_fn,
        num_images=num_images, goal_relabeling_strategy=goal_relabeling_strategy,
        read_parallelism=read_parallelism, cycle_length=cycle_length,
        process_index=process_index, process_count=process_count)
    if train:
        proc, _ = _process_shard(process_index, process_count)
        frames = _shuffle(frames, shuffle_buffer_size,
                          np.random.default_rng([seed + proc, 1]))
    threads = max(int(decode_parallelism or min(os.cpu_count() or 1, 8)), 1)
    decoded = _ordered_map(lambda f: _decode_frame(f, image_aug, train, task_augment_prob),
                           frames, threads)
    return _wrap_frame_iterator(decoded, batch_transform), {name: stats}


def _frame_structure(frame: Dict) -> tuple:
    """What tf.data's element_spec compares: the frame's keys, and each
    array's dtype and shape (bytes and strings by their type alone)."""
    return tuple(sorted((k, (v.dtype.str, v.shape) if isinstance(v, np.ndarray)
                         else type(v).__name__) for k, v in frame.items()))


def _peeked(stream: Iterator) -> Tuple[Optional[Dict], Iterator]:
    """(first item or None, the stream with it put back)."""
    first = next(stream, None)
    return first, (stream if first is None else itertools.chain([first], stream))


def _sample(streams: List[Iterator], weights: np.ndarray,
            rng: np.random.Generator) -> Iterator:
    """tf.data `sample_from_datasets(stop_on_empty_dataset=False)`: each item
    from a member drawn by the weights; an exhausted member leaves the draw
    (the others' weights renormalized), and the mixture ends with the last."""
    live = list(range(len(streams)))
    while live:
        w = weights[live] / weights[live].sum()
        i = live[int(rng.choice(len(live), p=w))]
        try:
            yield next(streams[i])
        except StopIteration:
            live.remove(i)


def make_interleaved_iterator(
    root: str,
    names: List[str],
    weights: List[float],
    batch_transform,
    platform: PlatformSpec,
    shuffle_buffer_size: int = 10_000,
    image_aug: bool = True,
    train: bool = True,
    seed: int = 0,
    balance_weights: bool = False,
    **kwargs,
) -> Tuple[Iterator[Dict[str, np.ndarray]], Dict]:
    """A weighted mixture of datasets (the JAX function; reference
    `make_interleaved_dataset`, rlds/dataset.py:458-589): returns
    (iterator, {name: stats}).

    Each member is `_build_encoded_frames` with `seed + i`; members are
    drawn by the normalised weights (`balance_weights` multiplies each by
    its dataset's `num_transitions` first); one shuffle buffer runs over the
    still-encoded frames of the mix, then one decode and augmentation stage.
    Where the members' frames differ in structure (OXE members whose
    `state_obs_keys` give proprio vectors of different widths), each member
    is shuffled and decoded on its own and the decoded frames are mixed on
    the host. The draws are the port's own numpy generators',
    so the order of samples is not TF's; the shares follow the weights.
    Other keyword arguments go to every member (`_build_encoded_frames`),
    and `task_augment_prob` and `decode_parallelism` to the decode stage."""
    task_augment_prob = kwargs.pop("task_augment_prob", 0.0)
    threads = max(int(kwargs.pop("decode_parallelism", None)
                      or min(os.cpu_count() or 1, 8)), 1)
    kwargs.pop("transform_parallelism", None)
    members, all_stats = [], {}
    for i, name in enumerate(names):
        frames, stats = _build_encoded_frames(root, name, platform, train=train, seed=seed + i,
                                              **kwargs)
        members.append(frames)
        all_stats[name] = stats

    w = np.asarray(weights, np.float64)
    if balance_weights:
        w = w * np.asarray([all_stats[n].get("num_transitions", 1) for n in names],
                           np.float64)
    w = w / w.sum()

    firsts = []
    for i, stream in enumerate(members):
        first, members[i] = _peeked(stream)
        firsts.append(first)
    structures = {_frame_structure(f) for f in firsts if f is not None}

    def decode(frames):
        return _ordered_map(lambda f: _decode_frame(f, image_aug, train, task_augment_prob),
                            frames, threads)

    if len(structures) <= 1:
        mixed = _sample(members, w, np.random.default_rng([seed, 2]))
        if train:
            mixed = _shuffle(mixed, shuffle_buffer_size, np.random.default_rng([seed, 1]))
        return _wrap_frame_iterator(decode(mixed), batch_transform), all_stats

    # The members' frames differ in structure: decode each on its own, mix on the host.
    its = []
    for i, frames in enumerate(members):
        if train:
            frames = _shuffle(frames, max(shuffle_buffer_size // len(members), 1),
                              np.random.default_rng([seed + i, 1]))
        its.append(_wrap_frame_iterator(decode(frames), batch_transform))
    return _sample(its, w, np.random.default_rng(seed)), all_stats
