"""Program auditor, the static passes (the counterpart of
``ddp_tpu/analysis``).

Three AST passes behind one findings model and one CLI (``python -m
ddp_tpu_torch.analysis --skip-programs``, see ``__main__.py``):

- **host-sync pass** (``hostsync``): device-to-host syncs (``.item()``,
  ``.cpu()``, ``float()`` of a step's output, ``torch.cuda.synchronize``)
  inside the step and epoch loops of ``train/``, ``data/``, ``serve/``,
  ``parallel/``.
- **lockset lint** (``lockset``): AST-derived shared-attribute access sets
  against declared lock scopes in the threaded subsystems.
- **divergence lint** (``divergence``): collectives reachable under
  rank-local conditions (rank checks, exception handlers, conditional
  early returns), the whole-job-hang shape.

The annotation vocabulary (``# analysis: shared-under(...)`` /
``unlocked-ok(...)`` / ``host-sync-ok(...)`` / ``divergence-ok(...)``) is
JAX's, the greppable audit trail for deliberate exceptions.  ``fixtures``
holds one seeded-faulty source per pass.  JAX's program auditors (the
jaxpr collective audit, the cost model, liveness) are ROADMAP A13c.2 to
A13c.4.
"""
from .findings import (Finding, SEVERITIES, count_by_severity,  # noqa: F401
                       format_table, make_finding)
from .hostsync import scan_packages  # noqa: F401
from .lockset import scan_modules  # noqa: F401
from .divergence import scan_source as divergence_scan_source  # noqa: F401
from .divergence import scan_packages as divergence_scan  # noqa: F401
from .fixtures import FIXTURES, fixture_names, run_fixture  # noqa: F401
