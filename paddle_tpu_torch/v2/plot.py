"""paddle.v2.plot analog (counterpart of `paddle_tpu/v2/plot.py`;
python/paddle/v2/plot/plot.py Ploter): live cost
curves during training. Falls back to appending to an in-memory series when
matplotlib is unavailable or headless (the reference disables itself outside
notebooks via DISABLE_PLOT)."""

from __future__ import annotations

import os
from typing import Dict, List


class PlotData:
    def __init__(self):
        self.step: List[float] = []
        self.value: List[float] = []

    def append(self, step: float, value: float) -> None:
        self.step.append(step)
        self.value.append(value)

    def reset(self) -> None:
        self.step, self.value = [], []


class Ploter:
    def __init__(self, *args: str):
        self.titles = list(args)
        self.data: Dict[str, PlotData] = {t: PlotData() for t in args}
        self._disabled = bool(os.environ.get("DISABLE_PLOT"))
        self._plt = None
        if not self._disabled:
            try:
                import matplotlib

                # headless environments get Agg (save-only); interactive
                # sessions keep their backend so plot() can display live
                if not os.environ.get("DISPLAY") and not os.environ.get(
                    "MPLBACKEND"
                ):
                    matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                self._plt = plt
            except Exception:
                self._plt = None

    def append(self, title: str, step: float, value: float) -> None:
        self.data[title].append(step, value)

    def plot(self, path: str = None) -> None:
        """Redraw; saves to `path`, or displays when interactive. Headless
        with no path is a no-op (nothing could be shown or kept)."""
        if self._plt is None:
            return
        plt = self._plt
        interactive = plt.get_backend().lower() != "agg"
        if path is None and not interactive:
            return
        plt.figure(figsize=(6, 4))
        for title in self.titles:
            d = self.data[title]
            if d.step:
                plt.plot(d.step, d.value, label=title)
        plt.legend()
        plt.xlabel("step")
        plt.ylabel("value")
        if path:
            plt.savefig(path)
        elif interactive:
            plt.show()
        plt.close()

    def reset(self) -> None:
        for d in self.data.values():
            d.reset()
