from repro_torch.streams.app import (  # noqa: F401
    Edge,
    Grouping,
    InstanceGraph,
    Operator,
    StreamApp,
    parallelize,
    source_sink_paths,
)
from repro_torch.streams.faults import (  # noqa: F401
    FailureRecord,
    FaultAbort,
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
from repro_torch.streams.fleet import (  # noqa: F401
    BackendCalibration,
    CampaignResult,
    FleetRunner,
    FleetShape,
    calibrate_backend,
    pad_sim,
    simulate_many,
    stack_sims,
)
from repro_torch.streams.placement import STRATEGIES, round_robin, packed, traffic_aware  # noqa: F401
from repro_torch.streams.scenarios import (  # noqa: F401
    Scenario,
    bench_fleet,
    campaign_fleet,
    capacity_sweep,
    compile_fleet,
    link_failure_sweep,
    random_app,
    random_scenarios,
    seed_fleet,
    time_varying_sweep,
)
from repro_torch.streams.simulator import (  # noqa: F401
    CAMPAIGN_METRICS,
    CompiledSim,
    SimResult,
    compile_sim,
    metric_index,
    sim_from_numpy,
    simulate,
)
from repro_torch.streams.workloads import (  # noqa: F401
    PAPER_CAPS_MBPS,
    WORKLOADS,
    linkedin_tags,
    motivation_chain,
    nexmark_q4,
    trending_topics,
    trucking_iot,
)
