"""The one door for contact-map plots.

Plots are host-side output, off the device path.  ``viz.plot`` (the
port's copy of the JAX package's) draws them with matplotlib; where matplotlib is not installed
the run prints one notice and goes on without plots.
"""

from __future__ import annotations

from typing import Optional

_available: Optional[bool] = None


def available() -> bool:
    """Whether matplotlib can be imported; the first ``False`` prints the
    notice.  Callers skip building a plot's matrix when this is false."""
    global _available
    if _available is None:
        try:
            import matplotlib  # noqa: F401
            _available = True
        except ModuleNotFoundError as exc:
            if not (exc.name or "").startswith("matplotlib"):
                raise
            print("plots skipped: matplotlib not installed")
            _available = False
    return _available


def plot_contact_map(*args, **kwargs) -> None:
    """``viz.plot.plot_contact_map``, or nothing
    when matplotlib is not installed."""
    if available():
        from hic_genome_assembler_tpu_torch.viz import plot as plot_mod

        plot_mod.plot_contact_map(*args, **kwargs)
