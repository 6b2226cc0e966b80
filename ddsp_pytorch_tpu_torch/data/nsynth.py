"""NSynth dataset utilities: filter by instrument, build per-instrument views.

Port of ddsp_pytorch_tpu/data/nsynth.py (standard library only; the CLI is
ddsp_pytorch_tpu_torch/nsynth_inst_split.py): parse a partition's
examples.json, filter notes by instrument string, and symlink the matching
wavs into ``target/partition/instrument/*.wav`` so preprocessing can read
one instrument's folder.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List

PARTITIONS = ("valid", "test", "train")


def load_examples(nsynth_partition_dir) -> Dict[str, dict]:
    """Parse examples.json of one NSynth partition directory."""
    with open(Path(nsynth_partition_dir) / "examples.json") as f:
        return json.load(f)


def filter_by_instrument(examples: Dict[str, dict], instrument_str: str) -> List[str]:
    """Note ids whose instrument_str (the note id where it has none)
    contains the query, e.g. 'violin'."""
    return [note_id for note_id, meta in examples.items()
            if instrument_str in meta.get("instrument_str", note_id)]


def create_inst_view(nsynth_root, target, instrument_str: str, partitions=PARTITIONS,
                     audio_subdir: str = "audio") -> Dict[str, int]:
    """Symlink the matching wavs into target/partition/instrument/ and
    return {partition: files linked}.  Partitions are read from
    nsynth_root/nsynth-{partition}/ (audio/ and examples.json inside); a
    missing partition is skipped, and a link that exists is kept."""
    nsynth_root = Path(nsynth_root)
    target = Path(target)
    counts = {}
    for partition in partitions:
        pdir = nsynth_root / f"nsynth-{partition}"
        if not pdir.exists():
            continue
        ids = filter_by_instrument(load_examples(pdir), instrument_str)
        out_dir = target / partition / instrument_str
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for note_id in ids:
            src = pdir / audio_subdir / f"{note_id}.wav"
            dst = out_dir / f"{note_id}.wav"
            if src.exists() and not dst.exists():
                os.symlink(src.resolve(), dst)
                n += 1
        counts[partition] = n
    return counts
