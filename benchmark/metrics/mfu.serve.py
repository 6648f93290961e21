"""The whole forward's share of the card's bf16 peak, in %: the model FLOPs
of every alert served in the window, counted from the configuration's
widths at each alert's own light-curve length and only where it carries a
spectrum (convolutions as direct ones, whatever route computes them), over
the window's length and 989 TFLOP/s."""

from benchmark.harness.readers import mfu


def read(reading):
    return mfu(reading)
