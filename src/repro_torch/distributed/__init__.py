"""Program distribution across processes and hosts: the TCP transport
(``transport``). The port of ``repro.distributed``'s transport; its sharding,
analytic, roofline and HLO modules are not ported (ROADMAP §1 item 11)."""
