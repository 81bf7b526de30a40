"""The cyclic garbage collector paused around bulk host work.

The text nodes map Python functions over every document of a dataset and
keep what they make: an n-gram featurizer makes ~500 lists a document,
millions over a corpus, all alive until the next node has run. Each
allocation of a container counts towards the collector's next pass, and
each full pass walks every live container, so a corpus's featurizing
spends most of its time in collections that free nothing (in
``chip_smoke.py``'s phase 12a, 18,846 documents of 250 words through
``NGramsFeaturizer`` on the 8-CPU host of an H100 machine: 11.4 s with
the collector on and, in a later run, 4.5 s with it paused). Those objects hold no reference cycles:
reference counting frees them. Pausing the collector for the map
changes no result; it is process wide, so other threads run without
cyclic collection meanwhile.
"""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def gc_paused():
    """The block with the cyclic collector off, restored to how it was."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
