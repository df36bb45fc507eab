"""Training-curve plotting (counterpart of paddle_tpu/utils/plot.py; ref
python/paddle/utils/plot.py).

The reference Ploter draws live matplotlib curves in notebooks and
falls back to printing in terminals.  Headless machines rarely have a
display, so the terminal path is primary here: append() always records
(and prints); plot() renders via matplotlib when it is importable and a
save path is given, else it is a no-op beyond the recorded history
(inspectable via ``ploter.data``).
"""

__all__ = ["PlotData", "Ploter"]


class PlotData(object):
    """One curve: step/value arrays (ref plot.py:19)."""

    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter(object):
    """Multi-curve recorder (ref plot.py:33): construct with curve
    titles, append(title, step, value) during training."""

    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {}
        for title in args:
            self.__plot_data__[title] = PlotData()

    @property
    def data(self):
        return self.__plot_data__

    def append(self, title, step, value):
        assert isinstance(title, str)
        assert title in self.__plot_data__
        data = self.__plot_data__[title]
        assert isinstance(data, PlotData)
        data.append(step, value)
        print("%s - step %s: %s" % (title, step, value))

    def plot(self, path=None):
        """Render all curves; writes a PNG when matplotlib is available
        and ``path`` is given, otherwise keeps terminal-only output."""
        if path is None:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        for title in self.__args__:
            d = self.__plot_data__[title]
            plt.plot(d.step, d.value, label=title)
        plt.legend()
        plt.savefig(path)
        plt.clf()

    def reset(self):
        for key in self.__plot_data__:
            self.__plot_data__[key].reset()
