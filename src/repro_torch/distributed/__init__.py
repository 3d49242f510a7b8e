"""Distribution and analysis: the TCP transport of lowered programs
(``transport``), the sharding rules and DTensor placements (``sharding``),
the analytic FLOP and byte count (``analytic``) and the three-term roofline
on the card's rates (``roofline``); the ports of ``repro.distributed``'s
modules of those names. JAX's HLO parser (``hloparse``) has no
counterpart: torch produces no HLO, so the roofline takes collective bytes
as an argument instead."""
