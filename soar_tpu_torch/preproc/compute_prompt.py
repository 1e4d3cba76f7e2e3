"""Prompt CLI (port of ``soar_tpu.preproc.compute_prompt``).

    python -m soar_tpu_torch.preproc.compute_prompt --data-dir DIR --prompt TEXT

Writes ``prompt.txt`` from ``--prompt``.  The reference's GPT-based
captioner is unfinished upstream and needs network access, so the prompt
is the user's.
"""

from __future__ import annotations

import argparse
import os.path as osp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--prompt", default=None)
    args = ap.parse_args(argv)

    if args.prompt is None:
        raise SystemExit("pass --prompt (the reference's GPT-based captioner is unfinished "
                         "upstream and requires network access)")
    out = osp.join(args.data_dir, "prompt.txt")
    with open(out, "w") as f:
        f.write(args.prompt.strip() + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
