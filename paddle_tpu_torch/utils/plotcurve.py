"""Plot training curves from a captured training log.

Counterpart of paddle_tpu/utils/plotcurve.py. Reference parity:
python/paddle/utils/plotcurve.py (plot_paddle_curve) —
grep metric values out of a training log and plot them. Understands both
the classic ``key=value`` log style and the trainer-loop debug prints
this framework emits (``step N: name=[v]``).
"""
import re
import sys

__all__ = ["extract_curve", "plot_paddle_curve", "main"]

_PAT = re.compile(r"([A-Za-z_][\w.\[\]]*)\s*=\s*\[?([-+0-9.eE]+)\]?")


def extract_curve(keys, lines):
    """{key: [values...]} for every requested key found in the lines."""
    out = {k: [] for k in keys}
    want = set(keys)
    for line in lines:
        for name, val in _PAT.findall(line):
            if name in want:
                try:
                    out[name].append(float(val))
                except ValueError:
                    pass
    return out


def plot_paddle_curve(keys, inputfile, outputfile, format="png",
                      show_fig=False):
    """Plot each key's series from ``inputfile`` (a file object or path)
    into ``outputfile``. Requires matplotlib; raises with guidance when
    it is absent (zero-egress images often omit it)."""
    close = False
    if isinstance(inputfile, str):
        inputfile = open(inputfile, "r")
        close = True
    try:
        curves = extract_curve(keys, inputfile)
    finally:
        if close:
            inputfile.close()
    if not any(curves.values()):
        raise ValueError("no values found for keys %r" % (keys,))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        raise ImportError(
            "plot_paddle_curve needs matplotlib; pip install matplotlib "
            "or use extract_curve() and plot with your own tooling")
    fig, ax = plt.subplots()
    for k, vals in curves.items():
        if vals:
            ax.plot(range(len(vals)), vals, label=k)
    ax.set_xlabel("sample")
    ax.legend()
    fig.savefig(outputfile, format=format)
    if show_fig:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)
    return curves


def main(argv):  # pragma: no cover - CLI veneer
    if len(argv) < 3:
        sys.stderr.write(
            "usage: python -m paddle_tpu_torch.utils.plotcurve key... "
            "logfile out.png\n")
        return 1
    *keys, infile, outfile = argv
    plot_paddle_curve(keys, infile, outfile)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
