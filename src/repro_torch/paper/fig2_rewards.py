"""Paper Figure 2: reward trends vs cluster membership, on the port.

Port of ``benchmarks/fig2_rewards.py``: runs BFLN with 2 and 7 clusters,
dumps per-client cumulative rewards and per-round cluster sizes, and
reports the paper's qualitative claims (recorded, not gated): clients in
larger clusters accumulate more tokens; more clusters give a more dispersed
reward distribution.

    python -m repro_torch.paper.fig2_rewards [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.paper.common import OUT_DIR, run_fl


def main(rounds: int = 10, out_path: str = str(OUT_DIR / "fig2.json"),
         device=None):
    out = {}
    for n_clusters in (2, 7):
        tr, _ = run_fl("synth10", 0.1, "bfln", rounds=rounds,
                       n_clusters=n_clusters, device=device)
        rewards = np.stack([h.rewards for h in tr.history])          # (R, m)
        sizes = np.stack([h.cluster_sizes[h.labels] for h in tr.history])
        cum = rewards.sum(axis=0)
        mean_size = sizes.mean(axis=0)
        corr = float(np.corrcoef(cum, mean_size)[0, 1])
        spread = float(cum.std())
        out[f"clusters-{n_clusters}"] = {
            "cumulative_rewards": cum.tolist(),
            "mean_cluster_size": mean_size.tolist(),
            "reward_size_correlation": corr,
            "reward_spread": spread,
            "balances": tr.ledger.balances.tolist(),
            "chain_valid": tr.chain.validate(),
            "ledger_conserved": tr.ledger.conserved(),
        }
        print(f"fig2,clusters-{n_clusters},corr={corr:.3f},spread={spread:.3f}",
              flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
