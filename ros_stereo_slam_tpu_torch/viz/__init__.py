"""Offline visualization: ``web`` (numpy only) and ``draw`` (matplotlib).

Verbatim copies of the reference's ``viz`` modules.  Unlike the
reference's package, importing this one does not import ``draw``, so
``web`` works on a host without matplotlib.
"""
