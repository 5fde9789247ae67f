"""Miniapps: self-validating distributed apps with a variant matrix.

Counterpart of ``tpu_patterns/miniapps``: a discovery framework
(``framework.py``) over apps laid out as ``apps/<app>/<variant>.py``, the
same ``<app>/<variant>`` convention.  An app runs over a rank mesh
(``comm/mesh.py``) instead of a device mesh.
"""

from tpu_patterns_torch.miniapps.framework import (  # noqa: F401
    DEFAULT_NP,
    VariantSpec,
    default_mesh,
    discover,
    get_variant,
    run_all,
    typed_runs,
)
