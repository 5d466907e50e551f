"""Scale-out over a device mesh: the tracks axis, the (tracks, time) axis
with halo exchange, and several processes joined by ``torch.distributed``
(port of ``stratum_dsp_tpu/parallel``)."""

from .mesh import analyze_batch_sharded, dryrun_multichip, make_mesh
