"""Daemon command-line builder.

The reference builds nydusd argv reflectively from struct tags
(pkg/daemon/command/command.go:20-102); here a dataclass maps 1:1 onto the
daemon server's argparse flags — one definition, typo-proof both ways.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, fields


@dataclass
class DaemonCommand:
    id: str = ""
    apisock: str = ""
    supervisor: str = ""
    workdir: str = ""
    log_file: str = ""
    upgrade: bool = False

    def build(self) -> list[str]:
        argv = [sys.executable, "-m", "nydus_snapshotter_tpu_torch.daemon.server"]
        for f in fields(self):
            value = getattr(self, f.name)
            flag = "--" + f.name.replace("_", "-")
            if isinstance(value, bool):
                if value:
                    argv.append(flag)
            elif value:
                argv += [flag, str(value)]
        return argv
