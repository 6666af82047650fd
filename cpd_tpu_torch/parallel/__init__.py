"""The distributed layer (port of `cpd_tpu.parallel`): integrity digests
here; the APS reduce in `aps`, `reduction`, `overlap`, `mesh`, `ring` and
`dist` (imported by module, as they import the kernels of `ops`)."""

from .integrity import DIGEST_MOD, row_digests, wire_digest

__all__ = ["DIGEST_MOD", "row_digests", "wire_digest"]
