"""fairseq-style TSV manifest (port of taiwan_whisper_tpu/audio/manifest.py):
the first line is the root dir, following lines are relative audio paths,
optionally "\\t<num_frames>"."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class Manifest:
    root: str
    paths: List[str]
    frames: Optional[List[int]] = None  # per-path sample counts, if known

    def __len__(self) -> int:
        return len(self.paths)

    def absolute_paths(self) -> List[str]:
        return [os.path.join(self.root, p) for p in self.paths]


def read_manifest(path: str) -> Manifest:
    with open(path, encoding="utf-8") as f:
        root = f.readline().strip()
        paths: List[str] = []
        frames: List[int] = []
        has_frames = True
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            paths.append(parts[0])
            if len(parts) > 1 and parts[1].isdigit():
                frames.append(int(parts[1]))
            else:
                has_frames = False
    return Manifest(root=root, paths=paths,
                    frames=frames if has_frames and frames else None)


def write_manifest(path: str, manifest: Manifest):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        print(manifest.root, file=f)
        for i, p in enumerate(manifest.paths):
            if manifest.frames is not None:
                print(f"{p}\t{manifest.frames[i]}", file=f)
            else:
                print(p, file=f)
