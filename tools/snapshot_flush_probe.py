"""What a snapshot's flush costs a host-bound training loop on the card's host.

The Executor's op walk is single-threaded Python that releases the GIL in
every torch call and launches a kernel for most of them. This probe times
such a loop (OPS small CUDA ops an iteration, the device never the bound)
alone and beside a background thread, each arm for the same wall time:

- `crc`: zlib.crc32 over a 256 MiB buffer, one long C call without the
  GIL: what the loop loses to a second busy core alone;
- `pack_stream`: `snapshot.write_snapshot` of a BERT-base-sized state
  (1010 float32 records, 1.3 GB, from pinned host memory) over and over:
  np.save a record at a time into memory, as the engine's flush first did
  (and as a blocking save still writes);
- `engine`: `AsyncSnapshotEngine.submit` of the same state on the card,
  then `drain`, over and over: the copy on the engine's stream and the
  flush of its slot image, as `CheckpointManager` runs them;
- `flush_py`: the records' np.save headers built in Python, nothing else:
  what holding the GIL alone costs.

It prints the loop's p50 ms an iteration for each, the ratio to the
mean of the loop alone before and after the others,
the CPUs the process may run on (os.sched_getaffinity) and the cgroup's
cpu.max where it is readable. Run on the card from the root of a
checkout:

    python tools/snapshot_flush_probe.py

It imports torch, numpy and paddle_tpu_torch only."""

from __future__ import annotations

import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OPS = 400  # small CUDA ops an iteration of the loop
WINDOW_S = 6.0  # wall time of each arm


def bert_like_state(torch, device=None):
    """Record sizes of BERT-base's persistables with Adam (3 x ~110 M
    floats in 1010 records), as pinned host tensors or on `device`."""
    sizes = [30522 * 768, 512 * 768, 2 * 768, 768 * 768, 30522]
    for _ in range(12):
        sizes += [768 * 2304, 2304, 768 * 768, 768, 768 * 3072, 3072, 3072 * 768, 768]
        sizes += [768] * 4
    sizes += [768] * 6
    state = {}
    for rep in range(3):  # the parameter and its two moments
        for i, n in enumerate(sizes):
            state[f"v{rep}_{i:04d}"] = torch.ones(n, dtype=torch.float32, device=device,
                                                  pin_memory=device is None)
    # pad to 1010 records with small ones, as BERT's biases and counters
    i = 0
    while len(state) < 1010:
        state[f"s_{i:04d}"] = torch.ones(1, dtype=torch.float32, device=device,
                                         pin_memory=device is None)
        i += 1
    return state


def main() -> int:
    import numpy as np
    import torch

    from paddle_tpu_torch.resilience import snapshot

    if not torch.cuda.is_available():
        print("snapshot_flush_probe: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cpu_max = None
    try:
        cpu_max = Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    except OSError:
        pass
    dev = torch.device("cuda", 0)
    x = torch.ones(64, device=dev)

    def iteration():
        t0 = time.perf_counter()
        y = x
        for _ in range(OPS // 2):
            y = y * 1.0001
            y = y + 0.5
        return (time.perf_counter() - t0) * 1e3

    state = bert_like_state(torch)
    nbytes = sum(t.numel() * 4 for t in state.values())
    big = np.ones(256 << 20, np.uint8)
    work = ROOT / "build" / "snapshot_flush_probe"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    on_card = bert_like_state(torch, dev)
    engine = snapshot.AsyncSnapshotEngine(str(work / "engine"), keep=1)

    def header_only():
        for name in sorted(state):
            a = snapshot._host(state[name])
            np.lib.format.write_array_header_1_0(
                io.BytesIO(), np.lib.format.header_data_from_array_1_0(a))

    def flush_once():
        snapshot.write_snapshot(str(work / "pack"), 0, state, keep=1)

    def engine_once():
        engine.submit(0, on_card)
        engine.drain()

    # alone first and last: the ratios are to the mean of the two
    backgrounds = [
        ("alone", None),
        ("crc", lambda: zlib.crc32(big)),
        ("pack_stream", flush_once),
        ("engine", engine_once),
        ("flush_py", header_only),
        ("alone_again", None),
    ]
    out = {"card": smi, "affinity_cpus": len(os.sched_getaffinity(0)),
           "cpu_count": os.cpu_count(), "cgroup_cpu_max": cpu_max,
           "state_bytes": nbytes, "records": len(state), "ops_an_iteration": OPS}
    t_end = time.perf_counter() + 2.0  # warm up: the state's pages, the loop
    while time.perf_counter() < t_end:
        iteration()
    torch.cuda.synchronize()
    arms = {}
    for tag, fn in backgrounds:
        stop = threading.Event()
        rounds = [0]

        def loop(fn=fn, stop=stop, rounds=rounds):
            while not stop.is_set():
                fn()
                rounds[0] += 1

        th = None
        if fn is not None:
            th = threading.Thread(target=loop, daemon=True)
            th.start()
            time.sleep(0.2)
        ms = []
        t_end = time.perf_counter() + WINDOW_S
        while time.perf_counter() < t_end:
            ms.append(iteration())
        stop.set()
        if th is not None:
            th.join()
        torch.cuda.synchronize()
        arms[tag] = {"p50_ms": round(statistics.median(ms), 4), "iterations": len(ms),
                     "background_rounds": rounds[0]}
    alone = (arms["alone"]["p50_ms"] + arms["alone_again"]["p50_ms"]) / 2
    for a in arms.values():
        a["ratio"] = round(a["p50_ms"] / alone, 3)
    out["arms"] = arms
    for tag, fn in (("pack_stream", flush_once), ("engine", engine_once)):
        t0 = time.perf_counter()
        fn()
        out[f"{tag}_alone_s"] = round(time.perf_counter() - t0, 3)
    out["engine_copy_ms"] = [round(x, 3) for x in engine.copy_ms[-3:]]
    out["engine_submit_ms"] = [round(x, 3) for x in engine.submit_ms[-3:]]
    engine.close()
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
