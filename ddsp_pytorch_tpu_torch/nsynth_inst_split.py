"""NSynth instrument-split CLI of the port (the counterpart of the
repository's nsynth-inst-split.py):

    python -m ddsp_pytorch_tpu_torch.nsynth_inst_split --nsynth-root /data/nsynth \\
        --target /data/views --instrument violin [--partitions valid test train]

Symlinks the notes whose instrument_str contains --instrument from
<nsynth-root>/nsynth-{valid,test,train}/{audio/, examples.json} into
<target>/<partition>/<instrument>/, for preprocessing one instrument.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    from ddsp_pytorch_tpu_torch.data.nsynth import PARTITIONS, create_inst_view

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nsynth-root", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--instrument", required=True,
                   help="substring matched against instrument_str, e.g. 'violin'")
    p.add_argument("--partitions", nargs="*", default=list(PARTITIONS))
    args = p.parse_args(argv)
    counts = create_inst_view(args.nsynth_root, args.target, args.instrument, partitions=args.partitions)
    for partition, n in counts.items():
        print(f"{partition}: {n} files linked")
    return counts


if __name__ == "__main__":
    main()
