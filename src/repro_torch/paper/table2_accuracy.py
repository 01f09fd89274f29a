"""Paper Table II: accuracy under non-IID label skew, on the port.

Port of ``benchmarks/table2_accuracy.py``: BFLN (cluster counts 2/5/7) vs
FedAvg / FedHKD / FedProto / FedProx on the synthetic stand-in datasets at
bias beta in {0.1, 0.3, 0.5} (20 clients, 12 rounds).

    python -m repro_torch.paper.table2_accuracy [--full] [--rounds R] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.paper.common import OUT_DIR, run_fl

STRATEGIES = ["bfln-2", "bfln-5", "bfln-7", "fedavg", "fedprox", "fedproto",
              "fedhkd"]


def run(datasets, biases, rounds, out_path, device=None):
    results = {}
    for ds in datasets:
        for bias in biases:
            for strat in STRATEGIES:
                t0 = time.time()
                if strat.startswith("bfln"):
                    _, acc = run_fl(ds, bias, "bfln", rounds=rounds,
                                    n_clusters=int(strat.split("-")[1]),
                                    device=device)
                else:
                    _, acc = run_fl(ds, bias, strat, rounds=rounds, device=device)
                key = f"{ds}-{bias}-{strat}"
                results[key] = acc
                print(f"table2,{key},{acc:.4f},{time.time()-t0:.0f}s", flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(full: bool = False, rounds: int = 12,
         out_path: str = str(OUT_DIR / "table2.json"), device=None):
    datasets = (["synth10", "synth100", "synthdigits"] if full
                else ["synth10", "synth100"])
    biases = [0.1, 0.3, 0.5]
    return run(datasets, biases, rounds, out_path, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(args.full, args.rounds, device=args.device)
