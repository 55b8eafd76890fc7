"""Load generation and roofline attribution for the port, ported from
``tpuserve/bench/``: ``loadgen`` (the ``bench`` subcommand's closed and
open loops, on the standard-library HTTP client in ``client``) and
``roofline`` (the ``/stats`` ``roofline`` block's pure functions)."""
