"""Daemon manager: lifecycle, recovery policies, live upgrade.

Reference pkg/manager/{manager.go,daemon_adaptor.go,daemon_event.go}:
a per-fs-driver manager holding a store-backed daemon cache, wiring each
daemon into the liveness monitor, and reacting to death events according to
the recovery policy — ``restart`` respawns and re-mounts instances via the
API, ``failover`` replays the supervisor-held state/fds into a fresh daemon
via takeover (SURVEY §3.4). The same takeover dance powers live upgrade.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import constants, failpoint
from nydus_snapshotter_tpu_torch.config.config import SnapshotterConfig
from nydus_snapshotter_tpu_torch.daemon.daemon import ConfigState, Daemon
from nydus_snapshotter_tpu_torch.daemon.types import DaemonState
from nydus_snapshotter_tpu_torch.manager.budget import RestartBudget
from nydus_snapshotter_tpu_torch.manager.monitor import DeathEvent, LivenessMonitor
from nydus_snapshotter_tpu_torch.rafs.rafs import Rafs
from nydus_snapshotter_tpu_torch.store.database import Database

logger = logging.getLogger(__name__)
from nydus_snapshotter_tpu_torch.supervisor.supervisor import SupervisorSet
from nydus_snapshotter_tpu_torch.utils import errdefs


class Manager:
    def __init__(
        self,
        cfg: SnapshotterConfig,
        database: Database,
        fs_driver: str = "",
        supervisor_set: Optional[SupervisorSet] = None,
    ):
        self.cfg = cfg
        self.db = database
        self.fs_driver = fs_driver or cfg.daemon.fs_driver
        self.recover_policy = cfg.daemon.recover_policy
        self._lock = threading.RLock()
        self._daemons: dict[str, Daemon] = {}
        self.monitor = LivenessMonitor()
        self.supervisors = supervisor_set or SupervisorSet(cfg.socket_root)
        self._event_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.on_death: Optional[Callable[[DeathEvent], None]] = None  # test hook
        self.cgroup_mgr = None  # optional pkg/cgroup Manager (daemon_adaptor.go:74-86)
        # Restart budget / circuit breaker: a crash-looping daemon gets
        # bounded respawns with backoff, then degrades to passthrough
        # instead of storming (knobs under [daemon] in the config TOML).
        dcfg = cfg.daemon
        self.restart_budget = RestartBudget(
            max_restarts=getattr(dcfg, "recover_max_restarts", 3),
            window=getattr(dcfg, "recover_window_secs", 60.0),
            base_delay=getattr(dcfg, "recover_backoff_secs", 0.5),
            max_delay=getattr(dcfg, "recover_backoff_max_secs", 8.0),
        )
        self.degraded: set[str] = set()
        self.on_degraded: Optional[Callable[[Daemon], None]] = None
        self._sleep: Callable[[float], None] = time.sleep

    # -- daemon book-keeping -------------------------------------------------

    def add_daemon(self, daemon: Daemon, persist: bool = True) -> None:
        with self._lock:
            if daemon.id in self._daemons:
                raise errdefs.AlreadyExists(f"daemon {daemon.id} already managed")
            self._daemons[daemon.id] = daemon
        if persist:
            self.db.save_daemon(daemon.id, daemon.states.to_dict())

    def update_daemon(self, daemon: Daemon) -> None:
        self.db.update_daemon(daemon.id, daemon.states.to_dict())

    def get_by_daemon_id(self, daemon_id: str) -> Optional[Daemon]:
        with self._lock:
            return self._daemons.get(daemon_id)

    def list_daemons(self) -> list[Daemon]:
        with self._lock:
            return list(self._daemons.values())

    def remove_daemon(self, daemon_id: str) -> None:
        with self._lock:
            self._daemons.pop(daemon_id, None)
        self.db.delete_daemon(daemon_id)

    # -- start/stop ----------------------------------------------------------

    def new_daemon(
        self,
        daemon_id: str,
        daemon_mode: str = "",
        use_supervisor: Optional[bool] = None,
    ) -> Daemon:
        """Allocate identity, sockets and workdir for a fresh daemon
        (reference daemon_adaptor.go:123-225 command/BuildDaemonCommand)."""
        os.makedirs(self.cfg.socket_root, exist_ok=True)
        workdir = os.path.join(self.cfg.root, "daemons", daemon_id)
        os.makedirs(workdir, exist_ok=True)
        if use_supervisor is None:
            use_supervisor = self.recover_policy == constants.RECOVER_POLICY_FAILOVER
        supervisor_path = ""
        if use_supervisor:
            supervisor_path = self.supervisors.new_supervisor(daemon_id).sock_path
        states = ConfigState(
            daemon_id=daemon_id,
            fs_driver=self.fs_driver,
            daemon_mode=daemon_mode or self.cfg.daemon_mode,
            api_socket=os.path.join(self.cfg.socket_root, f"{daemon_id}-api.sock"),
            log_file=os.path.join(workdir, "daemon.log"),
            workdir=workdir,
            supervisor_path=supervisor_path,
        )
        return Daemon(states)

    def start_daemon(self, daemon: Daemon, upgrade: bool = False) -> None:
        """Spawn + wait READY + subscribe liveness
        (reference daemon_adaptor.go:38-120)."""
        daemon.spawn(upgrade=upgrade)
        # Corral the daemon into the dedicated cgroup when one is managed
        # (daemon_adaptor.go:74-86).
        if self.cgroup_mgr is not None and daemon.pid:
            try:
                self.cgroup_mgr.add_proc(daemon.pid)
            except OSError as e:
                logger.warning("add daemon %s to cgroup: %s", daemon.id, e)
        daemon.client().wait_until_socket_exists()
        if not upgrade:
            daemon.wait_until_state(DaemonState.READY)
            daemon.start()
            daemon.wait_until_state(DaemonState.RUNNING)
        self.monitor.subscribe(daemon.id, daemon.states.api_socket)
        try:
            self.update_daemon(daemon)
        except errdefs.NotFound:
            pass

    def destroy_daemon(self, daemon: Daemon) -> None:
        """SIGTERM + reap + cleanup (reference manager.go:244-283)."""
        self.monitor.unsubscribe(daemon.id)
        try:
            daemon.exit()
        except (OSError, errdefs.NydusError, TimeoutError):
            pass
        daemon.terminate()
        daemon.wait()
        daemon.clear_vestige()
        self.supervisors.destroy(daemon.id)
        self.remove_daemon(daemon.id)
        self.restart_budget.reset(daemon.id)
        self.degraded.discard(daemon.id)

    # -- recovery ------------------------------------------------------------

    def recover(self) -> tuple[list[Daemon], list[Daemon]]:
        """Rebuild the daemon cache from the store after a snapshotter
        restart; split into still-live and dead daemons
        (reference manager.go:124-133, fs.go:124-193). A live daemon takes
        back its persisted RAFS instances, as manager.go's Recover walks
        them into every daemon: a later respawn re-mounts them, and a shared
        daemon's ref count stays true. (A dead daemon gets its instances as
        ``Filesystem.startup`` replays them.)"""
        live: list[Daemon] = []
        dead: list[Daemon] = []
        for state_dict in self.db.walk_daemons():
            states = ConfigState.from_dict(state_dict)
            if states.fs_driver != self.fs_driver:
                continue
            daemon = Daemon(states)
            self.add_daemon(daemon, persist=False)
            if daemon.state() in (DaemonState.RUNNING, DaemonState.READY):
                self.monitor.subscribe(daemon.id, states.api_socket)
                live.append(daemon)
            else:
                daemon.clear_vestige()
                dead.append(daemon)
        by_id = {d.id: d for d in live}
        for rec, _seq in self.db.walk_instances():
            daemon = by_id.get(rec.get("daemon_id"))
            if daemon is not None:
                daemon.add_rafs_instance(Rafs.from_dict(rec))
        return live, dead

    # -- death events --------------------------------------------------------

    def run_death_handler(self) -> None:
        self.monitor.run()
        self._stop.clear()
        self._event_thread = threading.Thread(target=self._death_loop, daemon=True)
        self._event_thread.start()

    def _death_loop(self) -> None:
        import queue

        while not self._stop.is_set():
            try:
                event = self.monitor.events.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.handle_death_event(event)
            except Exception:  # keep the loop alive; error is logged
                import logging

                logging.getLogger(__name__).exception(
                    "death handling for %s failed", event.daemon_id
                )
            if self.on_death is not None:
                self.on_death(event)

    def handle_death_event(self, event: DeathEvent) -> None:
        """Dispatch per recovery policy (reference daemon_event.go:43-138),
        metered by the restart budget: bounded respawns with exponential
        backoff, then circuit-open degradation."""
        daemon = self.get_by_daemon_id(event.daemon_id)
        if daemon is None:
            return
        if self.recover_policy == constants.RECOVER_POLICY_NONE:
            return  # leave it dead
        if event.daemon_id in self.degraded:
            return  # circuit already open; no respawn
        delay = self.restart_budget.next_delay(event.daemon_id)
        if delay is None:
            self._degrade(daemon)
            return
        if delay > 0:
            logger.warning(
                "daemon %s died again; backing off %.2fs before respawn (%d/%d in window)",
                daemon.id, delay,
                self.restart_budget.restarts_in_window(daemon.id),
                self.restart_budget.max_restarts,
            )
            self._sleep(delay)
        if self.recover_policy == constants.RECOVER_POLICY_FAILOVER:
            self.do_daemon_failover(daemon)
        elif self.recover_policy == constants.RECOVER_POLICY_RESTART:
            self.do_daemon_restart(daemon)

    def is_degraded(self, daemon_id: str) -> bool:
        return daemon_id in self.degraded

    def _degrade(self, daemon: Daemon) -> None:
        """Circuit open: stop respawning, clean up the corpse, and serve
        what's on disk (nodev-style passthrough) instead of hot-looping
        on a daemon that cannot stay up."""
        logger.error(
            "daemon %s exhausted its restart budget (%d respawns/%.0fs); "
            "degrading to passthrough",
            daemon.id, self.restart_budget.max_restarts, self.restart_budget.window,
        )
        self.degraded.add(daemon.id)
        self.monitor.unsubscribe(daemon.id)
        daemon.clear_vestige()
        if self.on_degraded is not None:
            self.on_degraded(daemon)

    def do_daemon_failover(self, daemon: Daemon) -> None:
        """Supervisor-held state + fd replay into a fresh process
        (reference daemon_event.go:70-107): reap, wait for pushed state,
        respawn with --upgrade, takeover, start."""
        daemon.wait(timeout=5)
        sup = self.supervisors.get(daemon.id)
        if sup is None or not sup.wait_for_state(timeout=10):
            # No saved session — degrade to a plain restart.
            self.do_daemon_restart(daemon)
            return
        daemon.spawn(upgrade=True)
        daemon.client().wait_until_socket_exists()
        daemon.wait_until_state(DaemonState.INIT)
        daemon.takeover()
        daemon.wait_until_state(DaemonState.READY)
        daemon.start()
        daemon.wait_until_state(DaemonState.RUNNING)
        self.monitor.subscribe(daemon.id, daemon.states.api_socket)
        self.update_daemon(daemon)

    def do_daemon_restart(self, daemon: Daemon) -> None:
        """Respawn + re-mount every instance via the API
        (reference daemon_event.go:109-137)."""
        failpoint.hit("manager.restart")
        daemon.wait(timeout=5)
        daemon.clear_vestige()
        self.start_daemon(daemon)
        configs = {}
        for rafs in daemon.instances.list():
            config_path = os.path.join(daemon.states.workdir, f"{rafs.snapshot_id}.json")
            if os.path.exists(config_path):
                with open(config_path) as f:
                    configs[rafs.snapshot_id] = f.read()
        daemon.recover_rafs_instances(daemon.instances.list(), configs)

    # -- live upgrade --------------------------------------------------------

    def do_daemon_upgrade(self, daemon: Daemon) -> None:
        """Zero-downtime binary swap using the same sendfd/takeover dance
        (reference daemon_event.go:141-218)."""
        daemon.send_fd()
        try:
            daemon.exit()
        except (OSError, errdefs.NydusError):
            pass
        daemon.terminate()
        self.monitor.unsubscribe(daemon.id)
        daemon.wait(timeout=10)
        self.do_daemon_failover(daemon)

    def stop(self) -> None:
        self._stop.set()
        if self._event_thread is not None:
            self._event_thread.join(timeout=2)
        self.monitor.stop()
