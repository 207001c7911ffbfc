"""The spread the bounds are set from, defined once."""

import statistics


def spread(values):
    """Inter-quartile distance over the median (statistics.quantiles'
    default exclusive method): the noise measure the bounds are set
    from."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
