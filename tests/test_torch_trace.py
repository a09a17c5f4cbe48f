"""The port's tracing plane on its serving surfaces against the JAX
package's.

Every case of tests/test_trace.py runs in both packages (``pkg``, through
``ported_cases``: the reference's own bodies): the span ring under
concurrent writers, span trees across the snapshot workers, the pipeline
and the blob cache, the Chrome export and the exemplar store, and the
traces served by ``SystemController`` (``/api/v1/traces``), by
``DaemonServer`` and by the ``pprof`` listener, and the collector errors
counted by ``MetricsServer``. tests/test_torch_planes.py holds the tracer
itself against the reference's with cross-package span trees.
"""

from __future__ import annotations

from tests.test_torch_fetch_sched import ported_cases

ported_cases("test_trace", globals())
