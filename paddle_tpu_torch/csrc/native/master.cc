// Elastic task master — go/master/service.go parity (SURVEY §2.2):
// fault-tolerant dataset-task dispatch with todo/pending/done queues, task
// timeouts + re-queue, failure caps, pass bookkeeping, and state snapshots.
//
// The Go reference keys recovery off etcd; here snapshots go to a local file
// (multi-host deployments put it on shared storage) and service discovery is
// the caller's. Trainers stay stateless task consumers:
// GetTask / TaskFinished / TaskFailed, exactly the reference RPC surface
// (service.go:368/:411/:455).

#include <chrono>
#include <cstdio>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <string>
#include <vector>

#include "common.h"

namespace pt {
namespace {

double now_s() {
  using namespace std::chrono;
  return duration<double>(steady_clock::now().time_since_epoch()).count();
}

struct Task {
  int64_t id = 0;
  std::string payload;  // chunk path list, newline-joined
  int failures = 0;
  double deadline = 0;  // pending only
};

struct Master {
  std::mutex mu;
  double timeout_s;
  int failure_max;
  int64_t next_id = 0;
  int pass = 0;
  std::deque<Task> todo;
  std::map<int64_t, Task> pending;
  std::vector<Task> done;
  std::vector<Task> discarded;  // failed > failure_max
  std::vector<std::string> dataset;  // payloads, kept to refill next pass

  void requeue_timeouts() {
    double t = now_s();
    for (auto it = pending.begin(); it != pending.end();) {
      if (it->second.deadline <= t) {
        Task task = it->second;
        it = pending.erase(it);
        fail_one(std::move(task));
      } else {
        ++it;
      }
    }
  }

  void fail_one(Task task) {
    if (++task.failures > failure_max)
      discarded.push_back(std::move(task));
    else
      todo.push_back(std::move(task));
  }

  void start_pass() {
    todo.clear();
    pending.clear();
    done.clear();
    discarded.clear();
    for (auto& p : dataset) {
      Task t;
      t.id = next_id++;
      t.payload = p;
      todo.push_back(std::move(t));
    }
  }
};

}  // namespace
}  // namespace pt

using pt::Master;
using pt::Task;

PT_EXPORT void* pt_master_create(double timeout_s, int failure_max) {
  auto* m = new (std::nothrow) Master();
  if (!m) return nullptr;
  m->timeout_s = timeout_s > 0 ? timeout_s : 60.0;
  m->failure_max = failure_max > 0 ? failure_max : 3;
  return m;
}

// payloads: n NUL-terminated strings concatenated; each becomes one task
// (the caller groups chunk paths into per-task payloads — chunks_per_task
// grouping happens in the Python layer that lists the recordio files).
PT_EXPORT void pt_master_set_dataset(void* mp, const char* payloads, int n) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  m->dataset.clear();
  const char* p = payloads;
  for (int i = 0; i < n; ++i) {
    m->dataset.emplace_back(p);
    p += m->dataset.back().size() + 1;
  }
  m->pass = 0;
  m->start_pass();
}

// Returns task id >= 0 and copies payload into buf (cap bytes incl. NUL);
// -1: no task available now (all pending — caller retries);
// -2: pass finished (todo+pending empty); -3: buffer too small.
PT_EXPORT int64_t pt_master_get_task(void* mp, char* buf, int64_t cap) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  m->requeue_timeouts();
  if (m->todo.empty()) return m->pending.empty() ? -2 : -1;
  Task t = std::move(m->todo.front());
  m->todo.pop_front();
  if (static_cast<int64_t>(t.payload.size()) + 1 > cap) {
    m->todo.push_front(std::move(t));
    return -3;
  }
  std::memcpy(buf, t.payload.c_str(), t.payload.size() + 1);
  t.deadline = pt::now_s() + m->timeout_s;
  int64_t id = t.id;
  m->pending[id] = std::move(t);
  return id;
}

PT_EXPORT int pt_master_task_finished(void* mp, int64_t id) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  auto it = m->pending.find(id);
  if (it == m->pending.end()) return -1;  // unknown/timed-out → already requeued
  m->done.push_back(std::move(it->second));
  m->pending.erase(it);
  return 0;
}

PT_EXPORT int pt_master_task_failed(void* mp, int64_t id) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  auto it = m->pending.find(id);
  if (it == m->pending.end()) return -1;
  Task t = std::move(it->second);
  m->pending.erase(it);
  m->fail_one(std::move(t));
  return 0;
}

// 1 if the pass is finished (everything done or discarded), else 0.
// next_pass=1 also refills the todo queue for the next pass.
PT_EXPORT int pt_master_pass_finished(void* mp, int next_pass) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  m->requeue_timeouts();
  if (!m->todo.empty() || !m->pending.empty()) return 0;
  if (next_pass) {
    ++m->pass;
    m->start_pass();
  }
  return 1;
}

// stats: out[0]=todo out[1]=pending out[2]=done out[3]=discarded out[4]=pass
PT_EXPORT void pt_master_stats(void* mp, int64_t* out) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  out[0] = static_cast<int64_t>(m->todo.size());
  out[1] = static_cast<int64_t>(m->pending.size());
  out[2] = static_cast<int64_t>(m->done.size());
  out[3] = static_cast<int64_t>(m->discarded.size());
  out[4] = m->pass;
}

// Snapshot format: "PTMS" | version | pass | next_id | section counts |
// length-prefixed payload+failures per task. Pending tasks snapshot as todo
// (on recovery they are re-dispatched — exactly the Go master's behavior of
// re-queuing leases that out-lived the process, service.go:166).
PT_EXPORT int pt_master_snapshot(void* mp, const char* path) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  auto w32 = [&](uint32_t v) { return fwrite(&v, 4, 1, f) == 1; };
  auto w64 = [&](int64_t v) { return fwrite(&v, 8, 1, f) == 1; };
  auto wtask = [&](const Task& t) {
    uint32_t len = static_cast<uint32_t>(t.payload.size());
    return w64(t.id) && w32(len) && w32(static_cast<uint32_t>(t.failures)) &&
           (len == 0 || fwrite(t.payload.data(), len, 1, f) == 1);
  };
  bool ok = w32(0x50544D53u) && w32(1) && w32(m->pass) && w64(m->next_id);
  ok = ok && w32(static_cast<uint32_t>(m->todo.size() + m->pending.size()));
  ok = ok && w32(static_cast<uint32_t>(m->done.size()));
  ok = ok && w32(static_cast<uint32_t>(m->dataset.size()));
  for (auto& t : m->todo) ok = ok && wtask(t);
  for (auto& kv : m->pending) ok = ok && wtask(kv.second);
  for (auto& t : m->done) ok = ok && wtask(t);
  for (auto& p : m->dataset) {
    uint32_t len = static_cast<uint32_t>(p.size());
    ok = ok && w32(len) && (len == 0 || fwrite(p.data(), len, 1, f) == 1);
  }
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

PT_EXPORT int pt_master_restore(void* mp, const char* path) {
  auto* m = static_cast<Master*>(mp);
  std::lock_guard<std::mutex> g(m->mu);
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  auto r32 = [&](uint32_t* v) { return fread(v, 4, 1, f) == 1; };
  auto r64 = [&](int64_t* v) { return fread(v, 8, 1, f) == 1; };
  // corrupt length fields must not drive multi-GiB allocations: bad_alloc
  // would escape the extern-C ABI and abort (same class recordio.cc caps)
  constexpr uint32_t kMaxBlob = 64u << 20;  // 64 MiB per payload/path
  auto rtask = [&](Task* t) {
    uint32_t len, fails;
    if (!r64(&t->id) || !r32(&len) || !r32(&fails)) return false;
    if (len > kMaxBlob) return false;
    t->failures = static_cast<int>(fails);
    t->payload.resize(len);
    return len == 0 || fread(&t->payload[0], len, 1, f) == 1;
  };
  uint32_t magic, version, pass, n_todo, n_done, n_data;
  int64_t next_id;
  bool ok = r32(&magic) && magic == 0x50544D53u && r32(&version) &&
            r32(&pass) && r64(&next_id) && r32(&n_todo) && r32(&n_done) &&
            r32(&n_data);
  // parse into locals and commit only after the whole file read cleanly —
  // a truncated/corrupt snapshot must leave the in-memory queues untouched
  // (same commit-after-parse shape as pt_opt_deserialize)
  std::deque<Task> todo;
  std::vector<Task> done;
  std::vector<std::string> dataset;
  if (ok) {
    for (uint32_t i = 0; ok && i < n_todo; ++i) {
      Task t;
      ok = rtask(&t);
      if (ok) todo.push_back(std::move(t));
    }
    for (uint32_t i = 0; ok && i < n_done; ++i) {
      Task t;
      ok = rtask(&t);
      if (ok) done.push_back(std::move(t));
    }
    for (uint32_t i = 0; ok && i < n_data; ++i) {
      uint32_t len;
      ok = r32(&len) && len <= kMaxBlob;
      if (!ok) break;
      std::string p(len, '\0');
      if (len) ok = fread(&p[0], len, 1, f) == 1;
      if (ok) dataset.push_back(std::move(p));
    }
  }
  fclose(f);
  if (!ok) return -1;
  m->todo = std::move(todo);
  m->pending.clear();
  m->done = std::move(done);
  m->discarded.clear();
  m->dataset = std::move(dataset);
  m->pass = static_cast<int>(pass);
  m->next_id = next_id;
  return 0;
}

PT_EXPORT void pt_master_destroy(void* mp) { delete static_cast<Master*>(mp); }
