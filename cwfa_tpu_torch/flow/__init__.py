"""cwfa_tpu_torch.flow — the invertible-flow library: invertible ops with
exact log-dets, as ``cwfa_tpu.flow`` exports them (the CWF steps compose
them statically, ``models/cwf.py``)."""

from cwfa_tpu_torch.flow.haar import (  # noqa: F401
    haar1d, haar2d_downsample, haar2d_upsample,
)
from cwfa_tpu_torch.flow.permute import (  # noqa: F401
    make_channel_perm, make_spatial_perm, apply_channel_perm,
    apply_spatial_perm, ReferencePermReplayer,
)
from cwfa_tpu_torch.flow.coupling import (  # noqa: F401
    clamp_fn, cat_transform, two_sided_coupling, one_sided_coupling,
    all_in_one_block, init_all_in_one_block,
)
from cwfa_tpu_torch.flow.actnorm import (  # noqa: F401
    init_actnorm, actnorm, actnorm_data_init,
)
from cwfa_tpu_torch.flow.subnets import (  # noqa: F401
    init_wavelet_flow_subnet2d, wavelet_flow_subnet2d,
    init_wavelet_flow_subnet2d_first, wavelet_flow_subnet2d_first,
    init_subnet_conv, subnet_conv,
)
from cwfa_tpu_torch.flow.core import numerical_logdet, check_inverse  # noqa: F401
