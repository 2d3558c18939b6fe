"""Static analysis of the engine's round (port of ``grapevine_tpu/analysis``,
the part ported so far): ``costmodel``, the analytic round-cost ledger."""
