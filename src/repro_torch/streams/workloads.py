"""The paper's test applications (§VI-A.2, Fig. 7) plus the motivating
examples (Fig. 1, Fig. 3), as synthetic workload generators.

Rates are calibrated so that derived-tuple rates exceed the provisioned
bandwidth (1.25–2.5 MB/s ≙ the paper's 10–20 Mbps), i.e. the network — not
CPU — is the bottleneck, matching the paper's data-intensive regime. The
real Twitter/IoT datasets are unavailable offline; generators preserve the
statistical shape the paper describes (arrival rates, tuple-size imbalance,
key skew).
"""
from __future__ import annotations

from repro_torch.streams.app import Edge, Grouping, Operator, StreamApp

# 10 Mbps / 15 Mbps / 20 Mbps in MB/s — the paper's three settings
PAPER_CAPS_MBPS = {"10Mbps": 1.25, "15Mbps": 1.875, "20Mbps": 2.5}


def trending_topics(parallelism: int = 2, n_wct: int = 4,
                    tweets_per_sec: float = 1200.0) -> StreamApp:
    """TT (Fig. 7 top): source → splitter → word-count (key-grouped, skewed)
    → top-K aggregator (windowed join over all WCT partitions) → report.

    1000 tweets/s (paper), ~1 KB avg emitted tuple. Key skew imbalances the
    WCT→aggregator flows; the aggregator needs *all* partitions per window,
    so TCP's equal split stalls it on the heavy partition (paper §VI-B).
    """
    gen_mb = tweets_per_sec / 1000.0  # 1 KB per tweet-tuple
    return StreamApp(
        name="trending_topics",
        operators=[
            Operator("source", parallelism, gen_rate=gen_mb, proc_rate=100.0),
            Operator("splitter", parallelism, proc_rate=100.0, selectivity=2.5),
            Operator("wct", n_wct, proc_rate=100.0, selectivity=0.8),
            Operator("aggregator", 1, proc_rate=50.0, selectivity=0.05, join=True),
            Operator("report", 1, proc_rate=50.0, selectivity=0.0),
        ],
        edges=[
            Edge("source", "splitter", Grouping.SHUFFLE),
            Edge("splitter", "wct", Grouping.KEY, key_skew=0.35),
            Edge("wct", "aggregator", Grouping.GLOBAL),
            Edge("aggregator", "report", Grouping.GLOBAL),
        ],
        tuples_per_mb=1000.0,
    )


def trucking_iot(parallelism: int = 2) -> StreamApp:
    """TI (Fig. 7 bottom): two sources with very different tuple sizes
    (heavy truck telemetry vs chatty traffic-congestion updates, paper
    §VI-A.2) parsed and combined by a lock-step join. Under TCP the heavy
    truck flow is throttled by the very frequent small-tuple flow; the
    combiner stalls waiting for truck data (paper §VI-B)."""
    truck_mb = 400.0 * 8e-3      # 3.2 MB/s of heavy telemetry tuples
    traffic_mb = 1250.0 * 1e-3   # 1.25 MB/s of chatty congestion updates
    return StreamApp(
        name="trucking_iot",
        operators=[
            Operator("truck_src", parallelism, gen_rate=truck_mb, proc_rate=100.0),
            Operator("traffic_src", parallelism, gen_rate=traffic_mb, proc_rate=100.0),
            Operator("truck_parse", parallelism, proc_rate=100.0, selectivity=1.0),
            Operator("traffic_parse", parallelism, proc_rate=100.0, selectivity=1.0),
            Operator("combiner", 1, proc_rate=50.0, selectivity=0.2, join=True),
            Operator("sink", 1, proc_rate=50.0, selectivity=0.0),
        ],
        edges=[
            Edge("truck_src", "truck_parse", Grouping.SHUFFLE),
            Edge("traffic_src", "traffic_parse", Grouping.SHUFFLE),
            Edge("truck_parse", "combiner", Grouping.GLOBAL),
            # each truck event joins with the LATEST congestion record: the
            # congestion stream is oversampled — only ~35% of the joined
            # input is congestion bytes; stale records are discarded at the
            # combiner (TCP keeps shipping them anyway).
            Edge("traffic_parse", "combiner", Grouping.GLOBAL,
                 join_share=0.35, droppable=True),
            Edge("combiner", "sink", Grouping.GLOBAL),
        ],
        tuples_per_mb=300.0,
    )


def linkedin_tags() -> StreamApp:
    """Fig. 1: the LinkedIn trending-tags example (Split → Skill/Job
    extractors → Merge → Count → TopK), parallelism 2 except the sink."""
    return StreamApp(
        name="linkedin_tags",
        operators=[
            Operator("split", 2, gen_rate=1.0, proc_rate=100.0),
            Operator("skill_extract", 2, proc_rate=100.0, selectivity=0.9),
            Operator("job_extract", 2, proc_rate=100.0, selectivity=0.9),
            Operator("merge", 2, proc_rate=100.0, selectivity=1.0, join=True),
            Operator("count", 2, proc_rate=100.0, selectivity=0.5),
            Operator("topk", 1, proc_rate=50.0, selectivity=0.0, join=True),
        ],
        edges=[
            Edge("split", "skill_extract", Grouping.SHUFFLE, weight=0.5),
            Edge("split", "job_extract", Grouping.SHUFFLE, weight=0.5),
            Edge("skill_extract", "merge", Grouping.KEY, key_skew=0.8, weight=1.0),
            Edge("job_extract", "merge", Grouping.KEY, key_skew=0.8, weight=1.0),
            Edge("merge", "count", Grouping.KEY, key_skew=0.6),
            Edge("count", "topk", Grouping.GLOBAL),
        ],
        tuples_per_mb=2000.0,
    )


def motivation_chain() -> StreamApp:
    """Fig. 3 micro-study: 4 operators, parallelism 1. Differing
    selectivities make the three flows' volumes unequal, so the right split
    of a shared uplink is *not* TCP's 50/50."""
    return StreamApp(
        name="motivation",
        operators=[
            Operator("src", 1, gen_rate=2.0, proc_rate=100.0),
            Operator("opA", 1, proc_rate=100.0, selectivity=0.6),
            Operator("opB", 1, proc_rate=100.0, selectivity=0.5),
            Operator("sink", 1, proc_rate=50.0, selectivity=0.0),
        ],
        edges=[
            Edge("src", "opA", Grouping.GLOBAL),
            Edge("opA", "opB", Grouping.GLOBAL),
            Edge("opB", "sink", Grouping.GLOBAL),
        ],
        tuples_per_mb=1000.0,
    )


def nexmark_q4(auction_src: int = 32, bid_src: int = 96,
               winning_bids: int = 128, categories: int = 5,
               auction_mb_s: float = 4918.0,
               bid_mb_s: float = 15082.0) -> StreamApp:
    """NEXmark Q4, "average price for a category", as a Storm topology:
    spouts on the auction and bid topics (Q4 reads no persons), a lock-step
    join of each auction with its bids keyed by auction id that keeps the
    winning bid of each closed auction, and an average of the winning bids
    keyed by category, reported to one sink.

    Apache Beam's ``NexmarkConfiguration`` defaults fix the event mix,
    person : auction : bid = 1 : 3 : 46, at 200 / 500 / 100 B a mean event:
    3 auctions and 46 bids join into 6,100 B, of which auctions are 1,500 B
    (the join takes its inputs in proportion to their volumes, the default
    ``join_share``), and the join keeps three ~100 B winning bids
    (selectivity 0.05). Bids are key-grouped by auction with a Zipf 0.35
    skew for the hot auctions; auctions and winning bids are spread evenly.
    ``auction_mb_s`` and ``bid_mb_s`` are each topic's total rate over its
    spouts; 1,000 MB/s of processing an instance keeps every operator off
    the CPU bound, so the network decides."""
    proc_rate = 1000.0
    return StreamApp(
        name="nexmark_q4",
        operators=[
            Operator("auction_src", auction_src, gen_rate=auction_mb_s,
                     proc_rate=proc_rate),
            Operator("bid_src", bid_src, gen_rate=bid_mb_s,
                     proc_rate=proc_rate),
            Operator("winning_bids", winning_bids, proc_rate=proc_rate,
                     selectivity=0.05, join=True),
            Operator("category_avg", categories, proc_rate=proc_rate,
                     selectivity=0.01),
            Operator("sink", 1, proc_rate=proc_rate, selectivity=0.0),
        ],
        edges=[
            Edge("auction_src", "winning_bids", Grouping.KEY),
            Edge("bid_src", "winning_bids", Grouping.KEY, key_skew=0.35),
            Edge("winning_bids", "category_avg", Grouping.KEY),
            Edge("category_avg", "sink", Grouping.GLOBAL),
        ],
        tuples_per_mb=8032.0,   # 124.5 B a mean event of the 1 : 3 : 46 mix
    )


WORKLOADS = {
    "TT": trending_topics,
    "TI": trucking_iot,
    "tags": linkedin_tags,
    "motivation": motivation_chain,
}
