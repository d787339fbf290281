# The paper's primary contribution: application-aware, online, dynamic
# bandwidth allocation (Alg. 1 + §VII multi-app fairness), on tensors.
from repro_torch.core.flowstate import (  # noqa: F401
    FlowState,
    flowstate_from_numpy,
    zeros as flowstate_zeros,
)
from repro_torch.core.allocator import (  # noqa: F401
    LinkProgram,
    OnlineAllocator,
    allocate,
    backfill,
    solve_downlink,
    solve_uplink,
)
from repro_torch.core.tcp import (  # noqa: F401
    demand_limited_maxmin,       # progressive-filling parity oracle
    demand_limited_maxmin_np,    # sequential numpy reference
    maxmin_fused,                # the hot-path fixed-trip solver
    maxmin_fused_step,           # order-cached per-tick variant
    maxmin_order_init,           # its initial carry
    maxmin_rates,                # progressive-filling parity oracle
)
from repro_torch.core.multiapp import (  # noqa: F401
    AppFairScheduler,
    ewma_throughput,
    group_by_throughput,
    jain_index,
    strict_priority_alloc,
)
