"""matplotlib for the drivers' figures, imported where a figure is drawn.

The port does not depend on matplotlib: ``api.evaluate``,
``api.record_schedule`` and the evaluator CLIs draw their figures with it,
as the JAX package's do, and import it only then. Where it is not
installed, ``pyplot(figure)`` raises an ``ImportError`` that names it and
the figure, so a driver never drops a figure without saying so; the numbers
behind each figure come from functions that need no matplotlib
(``api.evaluate_numbers``, ``evals.*``).
"""

from __future__ import annotations


def pyplot(figure: str):
    """``matplotlib.pyplot`` on the Agg backend, to draw ``figure``."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            f"drawing the figure {figure!r} needs matplotlib, which is not "
            "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
