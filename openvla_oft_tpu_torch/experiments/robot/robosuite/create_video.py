"""Render robosuite rollout pkls to annotated MP4s on the port (reference
`experiments/robot/robosuite/create_video.py`).

Each rollout pkl is a list of per-step dicts with
`obs.camera_front_image` / `obs.task_description`; the task string is
overlaid on a black band at the bottom of every frame. Needs imageio; the
annotation uses OpenCV where it exists, else frames are written
unannotated. Both are imported where they are used.

    python -m openvla_oft_tpu_torch.experiments.robot.robosuite.create_video \
        --path_to_pkl rollouts/ --output_dir videos/
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle


def annotate(img, text):
    """Draw `text` on a black band at the bottom-left (best effort: returns
    the frame unannotated when OpenCV is unavailable)."""
    try:
        import cv2
    except ImportError:
        return img
    import numpy as np

    img = np.ascontiguousarray(img)
    h = img.shape[0]
    font, scale, thick = cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1
    (tw, th), _ = cv2.getTextSize(text, font, scale, thick)
    pos = (10, h - 10)
    cv2.rectangle(img, (pos[0] - 5, pos[1] - th - 5),
                  (pos[0] + tw + 5, pos[1] + 5), (0, 0, 0), -1)
    cv2.putText(img, text, pos, font, scale, (0, 255, 0), thick, cv2.LINE_AA)
    return img


def render_rollout(pkl_path: str, out_dir: str, fps: int = 10) -> str:
    import imageio

    with open(pkl_path, "rb") as f:
        traj = pickle.load(f)
    task = traj[0]["obs"]["task_description"]
    out = os.path.join(out_dir,
                       os.path.basename(pkl_path).replace(".pkl", ".mp4"))
    try:
        writer = imageio.get_writer(out, fps=fps)
    except Exception:
        # no ffmpeg backend on this host — fall back to GIF (pure-python)
        out = out[:-4] + ".gif"
        writer = imageio.get_writer(out, duration=1000 / fps)
    for step in traj[:-1]:
        writer.append_data(annotate(step["obs"]["camera_front_image"], task))
    writer.close()
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path_to_pkl", required=True,
                   help="directory of rollout *.pkl files")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args()

    os.makedirs(args.output_dir, exist_ok=True)
    for pkl_file in sorted(glob.glob(os.path.join(args.path_to_pkl, "*.pkl"))):
        out = render_rollout(pkl_file, args.output_dir, args.fps)
        print(f"Saved video to {out}")


if __name__ == "__main__":
    main()
