"""The whole training step's share of the card's bf16 peak, in %: three
times the forward's model FLOPs of every sample trained on in the window,
counted from the configuration's widths at each sample's own light-curve
length (convolutions as direct ones), over the window's length and 989
TFLOP/s."""

from benchmark.harness.readers import mfu


def read(reading):
    return mfu(reading)
