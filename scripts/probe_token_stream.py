#!/usr/bin/env python3
"""Are ``data.token_stream``'s batches the same bits on every draw?

    python3 scripts/probe_token_stream.py [--vocab 151936] [--batch 4]
        [--seq 2048] [--n 6]

On the card and on the host, from a generator seeded 1: ``n`` batches
drawn in the main thread, again from a new generator, again after
skipping the first two (the launcher's resume), and in a background
thread (``TrainLoop``'s prefetcher) while the main thread keeps the card
busy with products.  One JSON line per device: each batch's digest per
mode and whether the modes agree.  Needs one CUDA card for the card's
line; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import sys
import threading
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.data import token_stream  # noqa: E402


def digests(batches) -> list:
    return [hashlib.sha256(b["tokens"].cpu().numpy().tobytes())
            .hexdigest()[:12] for b in batches]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=151936)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--n", type=int, default=6)
    args = ap.parse_args()
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        def stream():
            return token_stream(torch.Generator(device=dev).manual_seed(1),
                                args.vocab, args.batch, args.seq)

        main_a = digests(itertools.islice(stream(), args.n))
        main_b = digests(itertools.islice(stream(), args.n))
        skipped = digests(itertools.islice(stream(), 2, args.n))
        got: list = []

        def work():
            got.extend(itertools.islice(stream(), args.n))

        t = threading.Thread(target=work)
        busy = torch.randn(4096, 4096, device=dev)
        t.start()
        while t.is_alive():
            busy = torch.tanh(busy @ busy)
        t.join()
        threaded = digests(got)
        print(json.dumps(dict(
            device=dev, main=main_a, again=main_b, skipped=skipped,
            threaded=threaded, again_same=main_a == main_b,
            skipped_same=main_a[2:] == skipped,
            threaded_same=main_a == threaded)), flush=True)


if __name__ == "__main__":
    main()
