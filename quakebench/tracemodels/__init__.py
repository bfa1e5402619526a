"""The traces of one frame, one module an integrator, found by the
configuration's ``render.integrator`` (``quakebench/tracemodels/<name>.py``).
Each defines ``traces(cfg, px, alpha) -> [(rays, nearest?)]``: the traces
that the integrator's algorithm makes in a frame of ``px`` pixels after
the gbuffer's primary trace, from the configuration alone; ``alpha``
says whether the scene has alpha-tested triangles. quakebench/roofline.py
counts their work."""
