// optimizer-server: fanotify(7) container file-access tracer.
//
// C++ re-implementation of the reference Rust tool
// (tools/optimizer-server/src/main.rs:28-291) with the same contract:
//   env  _MNTNS_PID  pid whose pid+mnt namespaces to join (setns)
//   env  _TARGET     mount to mark (default "/")
//   out  one JSON object per newly-seen path on stdout:
//          {"path":"/usr/bin/sh","size":123,"elapsed":4567}
//        (elapsed = microseconds since tracer start)
//   SIGTERM ends the trace (self-pipe wakes the poll loop).
//
// The process joins the container's namespaces, forks (so the child is a
// full member of the target pid ns), and the child runs the fanotify loop.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <unordered_set>

#include <climits>
#include <fcntl.h>
#include <poll.h>
#include <sched.h>
#include <signal.h>
#include <sys/fanotify.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

namespace {

int g_sigterm_pipe[2] = {-1, -1};

void sigterm_handler(int) {
  const char byte = 1;
  // async-signal-safe wakeup of the poll loop (signal_hook::pipe role)
  ssize_t n = write(g_sigterm_pipe[1], &byte, 1);
  (void)n;
}

uint64_t now_micros() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000ull + ts.tv_nsec / 1000ull;
}

uint64_t g_begin = 0;

bool set_ns(const std::string &path, int nstype) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) {
    fprintf(stderr, "open %s: %s\n", path.c_str(), strerror(errno));
    return false;
  }
  int rc = setns(fd, nstype);
  close(fd);
  if (rc != 0) {
    fprintf(stderr, "setns %s: %s\n", path.c_str(), strerror(errno));
    return false;
  }
  return true;
}

bool join_namespace(const std::string &pid) {
  // main.rs:247-251: pid ns then mnt ns
  return set_ns("/proc/" + pid + "/ns/pid", CLONE_NEWPID) &&
         set_ns("/proc/" + pid + "/ns/mnt", CLONE_NEWNS);
}

// JSON string escaping for paths (quotes, backslashes, control bytes).
std::string json_escape(const std::string &s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += static_cast<char>(c);
        }
    }
  }
  return out;
}

void send_event(const std::string &path, uint64_t size) {
  // main.rs:164-171: one JSON line per event, flushed
  printf("{\"path\":\"%s\",\"size\":%llu,\"elapsed\":%llu}\n",
         json_escape(path).c_str(),
         static_cast<unsigned long long>(size),
         static_cast<unsigned long long>(now_micros() - g_begin));
  fflush(stdout);
}

void handle_events(int fanotify_fd, std::unordered_set<std::string> &seen) {
  alignas(struct fanotify_event_metadata) char buf[4096 * 4];
  for (;;) {
    ssize_t len = read(fanotify_fd, buf, sizeof buf);
    if (len <= 0) return;  // EAGAIN: drained (FAN_NONBLOCK)
    const struct fanotify_event_metadata *meta =
        reinterpret_cast<struct fanotify_event_metadata *>(buf);
    while (FAN_EVENT_OK(meta, len)) {
      if (meta->fd >= 0) {
        char link[64];
        snprintf(link, sizeof link, "/proc/self/fd/%d", meta->fd);
        char path[PATH_MAX + 1];
        ssize_t n = readlink(link, path, PATH_MAX);
        if (n > 0) {
          path[n] = '\0';
          std::string p(path);
          if (seen.insert(p).second) {
            struct stat st;
            // size via the open fd (main.rs generate_event_info)
            uint64_t size = (fstat(meta->fd, &st) == 0) ? st.st_size : 0;
            send_event(p, size);
          }
        }
        close(meta->fd);
      }
      meta = FAN_EVENT_NEXT(meta, len);
    }
  }
}

int run_tracer(const std::string &target) {
  // main.rs:107-133
  int fd = fanotify_init(FAN_CLOEXEC | FAN_CLASS_CONTENT | FAN_NONBLOCK,
                         O_RDONLY | O_LARGEFILE);
  if (fd < 0) {
    fprintf(stderr, "fanotify_init: %s\n", strerror(errno));
    return 1;
  }
  if (fanotify_mark(fd, FAN_MARK_ADD | FAN_MARK_MOUNT,
                    FAN_OPEN | FAN_ACCESS | FAN_OPEN_EXEC, AT_FDCWD,
                    target.c_str()) != 0) {
    fprintf(stderr, "fanotify_mark %s: %s\n", target.c_str(), strerror(errno));
    close(fd);
    return 1;
  }

  if (pipe(g_sigterm_pipe) != 0) {
    fprintf(stderr, "pipe: %s\n", strerror(errno));
    return 1;
  }
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_handler = sigterm_handler;
  sigaction(SIGTERM, &sa, nullptr);

  std::unordered_set<std::string> seen;
  struct pollfd fds[2] = {
      {fd, POLLIN, 0},
      {g_sigterm_pipe[0], POLLIN, 0},
  };
  // main.rs:183-238
  for (;;) {
    int rc = poll(fds, 2, -1);
    if (rc < 0) {
      if (errno == EINTR) continue;
      fprintf(stderr, "poll: %s\n", strerror(errno));
      break;
    }
    if (fds[0].revents & POLLIN) handle_events(fd, seen);
    if (fds[1].revents & POLLIN) {
      fprintf(stderr, "received SIGTERM signal\n");
      break;
    }
  }
  close(fd);
  return 0;
}

}  // namespace

int main() {
  g_begin = now_micros();
  const char *pid = getenv("_MNTNS_PID");
  const char *target_env = getenv("_TARGET");
  std::string target = target_env ? target_env : "/";

  if (pid && *pid) {
    if (!join_namespace(pid)) return 1;
  }

  // fork so the child fully enters the joined pid namespace (main.rs:256-288)
  pid_t child = fork();
  if (child < 0) {
    fprintf(stderr, "fork: %s\n", strerror(errno));
    return 1;
  }
  if (child == 0) {
    return run_tracer(target);
  }
  fprintf(stderr, "forked optimizer server subprocess, pid: %d\n", child);
  int status = 0;
  if (waitpid(child, &status, 0) < 0) {
    fprintf(stderr, "failed to wait for child process: %s\n", strerror(errno));
    return 1;
  }
  if (WIFSIGNALED(status)) {
    fprintf(stderr, "child process %d was killed by signal %d\n", child,
            WTERMSIG(status));
  }
  return WIFEXITED(status) ? WEXITSTATUS(status) : 0;
}
