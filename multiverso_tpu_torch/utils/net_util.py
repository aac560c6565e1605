"""Host self-identification for machine-file deployments.

Port of ``multiverso_tpu/utils/net_util.py``; ``core/zoo.py`` calls
:func:`rank_from_machine_file` for the ``-machine_file`` start-up.

Parity with the reference's ``net_util`` (``src/util/net_util.cpp``,
``include/multiverso/util/net_util.h:10``): enumerate this host's IP
addresses and derive the process rank as the index of the matching entry in
a machine file — the ZMQ deployment mode where rank assignment is "my IP's
line number" (``zmq_net.h:25-61``).
"""

from __future__ import annotations

import socket
from typing import List, Optional, Tuple


def get_local_ips() -> List[str]:
    """Best-effort local address enumeration (loopback always included):
    the host name, the IPv4 addresses it resolves to, and the source
    address of the default route."""
    ips = {"127.0.0.1", "localhost"}
    hostname = socket.gethostname()
    ips.add(hostname)
    try:
        for info in socket.getaddrinfo(hostname, None):
            addr = info[4][0]
            if ":" not in addr:          # keep it IPv4 like the reference
                ips.add(addr)
    except socket.gaierror:
        pass
    # The UDP-connect trick reveals the address of the default route: a
    # datagram socket's connect only asks the kernel for a route, so no
    # packet leaves the host. A host whose name resolves to loopback alone
    # still finds its routable address here.
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            ips.add(s.getsockname()[0])
    except OSError:
        pass
    return sorted(ips)


def parse_machine_file(path: str) -> List[Tuple[str, int]]:
    """Lines of ``host[:port]``; comments/blank lines skipped. Default port
    comes from the ``-port`` flag."""
    from multiverso_tpu_torch.utils.configure import get_flag

    default_port = get_flag("port")
    out: List[Tuple[str, int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            host, _, port = line.partition(":")
            out.append((host.strip(),
                        int(port) if port else int(default_port)))
    return out


def rank_from_machine_file(path: str,
                           local_ips: Optional[List[str]] = None
                           ) -> Tuple[int, int, List[Tuple[str, int]]]:
    """Returns (rank, world_size, peers). Rank = index of the first machine
    entry whose host matches one of this host's addresses
    (ref zmq_net.h:25-61). Raises if no entry matches."""
    peers = parse_machine_file(path)
    ips = set(local_ips if local_ips is not None else get_local_ips())
    for i, (host, _) in enumerate(peers):
        if host in ips:
            return i, len(peers), peers
    raise LookupError(
        f"none of this host's addresses {sorted(ips)} appear in "
        f"machine file '{path}'")
