"""§VII demo on the PyTorch port: five applications with 1..5 flows sharing
one bottleneck. TCP's flow-level fairness hands the many-flow app the
biggest share; App-Fair's EWMA grouping + strict priority + displacement
equalizes the apps (paper: Jain 0.84 -> 0.98+).

    PYTHONPATH=src python examples/port_multiapp_fairness.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import AppFairScheduler, jain_index, maxmin_rates
from repro_torch.device import resolve_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    n_apps = 5
    app_of_flow = np.concatenate([[a] * (a + 1) for a in range(n_apps)])
    F = len(app_of_flow)
    R = torch.ones((F, 1), dtype=torch.float32, device=dev)
    cap = torch.tensor([100.0], device=dev)
    apps = torch.as_tensor(app_of_flow, device=dev)

    x = maxmin_rates(R, cap).cpu().numpy()
    tcp = np.array([x[app_of_flow == a].sum() for a in range(n_apps)])
    tcp_jain = float(jain_index(torch.as_tensor(tcp)))
    print("TCP     per-app Mb/s:", np.round(tcp, 1),
          " Jain:", round(tcp_jain, 3))

    out = {"tcp": tcp, "tcp_jain": tcp_jain, "appfair": {}}
    for alpha in (0.25, 0.5, 0.75, 1.0):
        sched = AppFairScheduler(n_apps, alpha=alpha, n_groups=5, device=dev)
        state = sched.init()
        total = np.zeros(n_apps)
        prev = np.zeros(n_apps, np.float32)
        T = 60
        for _ in range(T):
            state, xf = sched.step(state, torch.as_tensor(prev, device=dev),
                                   R, cap, apps)
            xn = xf.cpu().numpy()
            per = np.array([xn[app_of_flow == a].sum()
                            for a in range(n_apps)])
            total += per
            prev = per.astype(np.float32)
        avg = total / T
        jain = float(jain_index(torch.as_tensor(avg)))
        print(f"App-Fair(α={alpha:4.2f}) per-app:", np.round(avg, 1),
              " Jain:", round(jain, 3))
        out["appfair"][alpha] = (avg, jain)
    return out


if __name__ == "__main__":
    main()
