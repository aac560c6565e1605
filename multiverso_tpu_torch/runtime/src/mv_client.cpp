// extern "C" table FFI: a foreign-host client for the DCN PS wire protocol.
//
// The reference exposes tables to non-C++ hosts through a flat C ABI
// (include/multiverso/c_api.h:16-54, src/c_api.cpp:10-92) that Lua/C#/CLR
// dlopen. Here the equivalent boundary is the framed TCP wire protocol
// (parallel/net.py of either package): this file implements that protocol in
// plain C++ so ANY language with a C FFI can attach to Python-served PS
// shards — create table handles, Add, Get — with the same partitioning
// arithmetic the Python DistributedArray/Matrix/KV tables use.
//
// Surface mirrors the reference's names (MV_NewArrayTable,
// MV_GetArrayTable, MV_AddArrayTable, MV_*MatrixTable*) with one explicit
// addition: MV_ConnectClient, because a foreign host attaches over DCN
// (peer list) rather than riding an in-process MPI world.
//
// Wire frame (little-endian, parallel/net.py):
//   u32 magic 'MVTP' | i32 type | i32 table_id | i64 msg_id | i32 src |
//   i32 n_blobs | blobs: { char[16] numpy dtype tag | u32 ndim |
//                          i64 dims[ndim] | i64 nbytes | raw }
// All calls are synchronous: one request per connection at a time, so the
// next reply on that FIFO stream is ours (no reply router needed).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4D565450;  // "MVTP" (net.py _MAGIC_VALUE)
constexpr int32_t kRequestGet = 1;       // core/actor.py MsgType
constexpr int32_t kRequestAdd = 2;
constexpr int32_t kReplyError = -99;
constexpr int32_t kWireRaw = 0;          // ps_service.py payload marker
constexpr int32_t kWireSparse = 1;

struct Blob {
  std::string dtype;            // numpy dtype.str, e.g. "<f4"
  std::vector<int64_t> shape;
  std::vector<uint8_t> raw;

  int64_t elems() const {
    int64_t n = 1;
    for (int64_t d : shape) n *= d;
    return shape.empty() ? 1 : n;
  }
};

struct Msg {
  int32_t type = 0;
  int32_t table_id = -1;
  int64_t msg_id = -1;
  int32_t src = -1;
  std::vector<Blob> blobs;
};

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

template <typename T>
void put(std::vector<uint8_t>& out, T v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out.insert(out.end(), p, p + sizeof(T));
}

bool send_msg(int fd, const Msg& m) {
  std::vector<uint8_t> buf;
  put<uint32_t>(buf, kMagic);
  put<int32_t>(buf, m.type);
  put<int32_t>(buf, m.table_id);
  put<int64_t>(buf, m.msg_id);
  put<int32_t>(buf, m.src);
  put<int32_t>(buf, static_cast<int32_t>(m.blobs.size()));
  for (const Blob& b : m.blobs) {
    char tag[16] = {0};
    std::strncpy(tag, b.dtype.c_str(), sizeof(tag) - 1);
    buf.insert(buf.end(), tag, tag + 16);
    put<uint32_t>(buf, static_cast<uint32_t>(b.shape.size()));
    for (int64_t d : b.shape) put<int64_t>(buf, d);
    put<int64_t>(buf, static_cast<int64_t>(b.raw.size()));
    buf.insert(buf.end(), b.raw.begin(), b.raw.end());
  }
  return send_all(fd, buf.data(), buf.size());
}

bool recv_msg(int fd, Msg* out) {
  uint32_t magic;
  if (!recv_all(fd, &magic, 4) || magic != kMagic) return false;
  if (!recv_all(fd, &out->type, 4) || !recv_all(fd, &out->table_id, 4) ||
      !recv_all(fd, &out->msg_id, 8) || !recv_all(fd, &out->src, 4))
    return false;
  int32_t n_blobs;
  if (!recv_all(fd, &n_blobs, 4) || n_blobs < 0 || n_blobs > 1 << 16)
    return false;
  out->blobs.clear();
  out->blobs.resize(static_cast<size_t>(n_blobs));
  for (Blob& b : out->blobs) {
    char tag[17] = {0};
    uint32_t ndim;
    if (!recv_all(fd, tag, 16) || !recv_all(fd, &ndim, 4) || ndim > 16)
      return false;
    b.dtype = tag;
    b.shape.resize(ndim);
    for (uint32_t i = 0; i < ndim; ++i)
      if (!recv_all(fd, &b.shape[i], 8)) return false;
    int64_t nbytes;
    if (!recv_all(fd, &nbytes, 8) || nbytes < 0 || nbytes > (1LL << 40))
      return false;
    b.raw.resize(static_cast<size_t>(nbytes));
    if (nbytes && !recv_all(fd, b.raw.data(), b.raw.size())) return false;
  }
  return true;
}

template <typename T>
Blob make_blob(const char* dtype, const T* data, int64_t n,
               int64_t cols = -1) {
  Blob b;
  b.dtype = dtype;
  if (cols < 0) {
    b.shape = {n};
  } else {
    b.shape = {n / cols, cols};
  }
  if (n > 0 && data != nullptr) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data);
    b.raw.assign(p, p + static_cast<size_t>(n) * sizeof(T));
  }
  return b;
}

Blob opt_blob() {
  // AddOption scalars [worker_id, momentum, lr, rho, lambda] — the
  // foreign host is worker 0 with a plain-add updater.
  float opt[5] = {0, 0, 0, 0, 0};
  return make_blob<float>("<f4", opt, 5);
}

Blob marker_blob(const std::vector<int64_t>& shape) {
  // pack_payload raw marker: int64 [mode=0, ndim, *dims]
  std::vector<int64_t> m = {kWireRaw,
                            static_cast<int64_t>(shape.size())};
  m.insert(m.end(), shape.begin(), shape.end());
  return make_blob<int64_t>("<i8", m.data(),
                            static_cast<int64_t>(m.size()));
}

// Decode a filtered float payload (marker + blobs) into out[0..n).
// Handles raw and sparse modes (ps_service.py pack_payload).
bool decode_payload(const std::vector<Blob>& blobs, size_t at, float* out,
                    int64_t n) {
  if (at >= blobs.size()) return false;
  const Blob& marker = blobs[at];
  if (marker.raw.size() < 16) return false;
  const int64_t* m = reinterpret_cast<const int64_t*>(marker.raw.data());
  int64_t mode = m[0], ndim = m[1], total = ndim ? 1 : 1;
  for (int64_t i = 0; i < ndim; ++i) total *= m[2 + i];
  if (total > n) total = n;
  if (mode == kWireRaw) {
    if (at + 1 >= blobs.size()) return false;
    const Blob& payload = blobs[at + 1];
    std::memcpy(out, payload.raw.data(),
                static_cast<size_t>(total) * sizeof(float));
    return true;
  }
  if (mode == kWireSparse) {
    if (at + 2 >= blobs.size()) return false;
    const Blob& idx = blobs[at + 1];
    const Blob& vals = blobs[at + 2];
    std::memset(out, 0, static_cast<size_t>(total) * sizeof(float));
    const int64_t k = idx.elems();
    const float* v = reinterpret_cast<const float*>(vals.raw.data());
    // SparseFilter emits int32 or int64 indices depending on size.
    if (idx.dtype == "<i4") {
      const int32_t* ix = reinterpret_cast<const int32_t*>(idx.raw.data());
      for (int64_t i = 0; i < k; ++i)
        if (ix[i] >= 0 && ix[i] < total) out[ix[i]] = v[i];
    } else {
      const int64_t* ix = reinterpret_cast<const int64_t*>(idx.raw.data());
      for (int64_t i = 0; i < k; ++i)
        if (ix[i] >= 0 && ix[i] < total) out[ix[i]] = v[i];
    }
    return true;
  }
  return false;  // onebit never appears on reply legs
}

struct MvClient {
  std::vector<int> fds;
  std::mutex mu;
  int64_t next_id;
  int32_t src;
};

// The reference's contiguous partition (src/table/array_table.cpp:98-108;
// parallel/mesh.py reference_server_offsets): even split, last server
// takes the remainder.
std::vector<int64_t> server_offsets(int64_t size, int world) {
  std::vector<int64_t> off;
  int64_t each = world ? size / world : size;
  for (int s = 0; s < world; ++s)
    off.push_back(std::min<int64_t>(s * each, size));
  off.push_back(size);
  return off;
}

enum TableKind { kArray, kMatrix, kKV };

struct MvTable {
  MvClient* client;
  int32_t table_id;
  int64_t rows, cols;   // array: rows=size, cols=1
  TableKind kind;
  std::vector<int64_t> offsets;  // array: elements; matrix: rows
};

// One synchronous round trip on server s. Returns false on socket error
// or an explicit Reply_Error.
bool round_trip(MvClient* c, int s, Msg* m, Msg* reply) {
  {
    std::lock_guard<std::mutex> lk(c->mu);
    m->msg_id = c->next_id++;
    m->src = c->src;
  }
  if (!send_msg(c->fds[static_cast<size_t>(s)], *m)) return false;
  if (!recv_msg(c->fds[static_cast<size_t>(s)], reply)) return false;
  return reply->type != kReplyError;
}

}  // namespace

extern "C" {

// peers: "host:port;host:port;..." — one PS shard per entry, in rank
// order (the same peer list the Python side passes to net_connect).
int MV_ConnectClient(const char* peers, void** out_client) {
  if (!peers || !out_client) return -1;
  auto* c = new MvClient();
  std::random_device rd;
  // Random 48-bit msg-id base + a high src id: a foreign host must never
  // collide with rank (src, msg_id) streams in the server's
  // exactly-once reply cache.
  c->next_id = (static_cast<int64_t>(rd()) << 16) ^ rd();
  if (c->next_id < 0) c->next_id = -c->next_id;
  c->src = 1 << 20 | static_cast<int32_t>(rd() & 0xFFFFF);
  std::string str(peers);
  size_t pos = 0;
  while (pos < str.size()) {
    size_t sep = str.find(';', pos);
    std::string entry = str.substr(
        pos, sep == std::string::npos ? std::string::npos : sep - pos);
    pos = sep == std::string::npos ? str.size() : sep + 1;
    size_t colon = entry.rfind(':');
    if (colon == std::string::npos) continue;
    std::string host = entry.substr(0, colon);
    int port = std::atoi(entry.c_str() + colon + 1);
    struct addrinfo hints = {}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res) {
      delete c;
      return -2;
    }
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    auto* addr = reinterpret_cast<struct sockaddr_in*>(res->ai_addr);
    addr->sin_port = htons(static_cast<uint16_t>(port));
    int rc = ::connect(fd, res->ai_addr, sizeof(*addr));
    freeaddrinfo(res);
    if (rc != 0) {
      ::close(fd);
      delete c;
      return -3;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    c->fds.push_back(fd);
  }
  if (c->fds.empty()) {
    delete c;
    return -4;
  }
  *out_client = c;
  return 0;
}

void MV_CloseClient(void* client) {
  auto* c = static_cast<MvClient*>(client);
  if (!c) return;
  for (int fd : c->fds) ::close(fd);
  delete c;
}

int MV_NumServers(void* client) {
  auto* c = static_cast<MvClient*>(client);
  return c ? static_cast<int>(c->fds.size()) : 0;
}

// -- array table (ref c_api.h MV_NewArrayTable/MV_GetArrayTable/
//    MV_AddArrayTable; table must be served by the Python side) ----------
int MV_NewArrayTable(void* client, int table_id, long long size,
                     void** out_table) {
  auto* c = static_cast<MvClient*>(client);
  if (!c || !out_table || size <= 0) return -1;
  auto* t = new MvTable{c, table_id, size, 1, kArray,
                        server_offsets(size, static_cast<int>(
                                                 c->fds.size()))};
  *out_table = t;
  return 0;
}

int MV_AddArrayTable(void* table, const float* delta, long long size) {
  auto* t = static_cast<MvTable*>(table);
  if (!t || t->kind != kArray || size != t->rows) return -1;
  for (size_t s = 0; s + 1 < t->offsets.size(); ++s) {
    int64_t lo = t->offsets[s], hi = t->offsets[s + 1];
    if (hi <= lo) continue;
    Msg m, reply;
    m.type = kRequestAdd;
    m.table_id = t->table_id;
    m.blobs.push_back(make_blob<int32_t>("<i4", nullptr, 0));
    m.blobs.push_back(opt_blob());
    m.blobs.push_back(marker_blob({hi - lo}));
    m.blobs.push_back(make_blob<float>("<f4", delta + lo, hi - lo));
    if (!round_trip(t->client, static_cast<int>(s), &m, &reply)) return -2;
  }
  return 0;
}

int MV_GetArrayTable(void* table, float* data, long long size) {
  auto* t = static_cast<MvTable*>(table);
  if (!t || t->kind != kArray || size != t->rows) return -1;
  for (size_t s = 0; s + 1 < t->offsets.size(); ++s) {
    int64_t lo = t->offsets[s], hi = t->offsets[s + 1];
    if (hi <= lo) continue;
    Msg m, reply;
    m.type = kRequestGet;
    m.table_id = t->table_id;
    m.blobs.push_back(make_blob<int32_t>("<i4", nullptr, 0));
    if (!round_trip(t->client, static_cast<int>(s), &m, &reply)) return -2;
    if (!decode_payload(reply.blobs, 0, data + lo, hi - lo)) return -3;
  }
  return 0;
}

// -- matrix table (row-sharded; ref MV_*MatrixTableByRows) ---------------
int MV_NewMatrixTable(void* client, int table_id, long long num_row,
                      long long num_col, void** out_table) {
  auto* c = static_cast<MvClient*>(client);
  if (!c || !out_table || num_row <= 0 || num_col <= 0) return -1;
  auto* t = new MvTable{c, table_id, num_row, num_col, kMatrix,
                        server_offsets(num_row, static_cast<int>(
                                                    c->fds.size()))};
  *out_table = t;
  return 0;
}

namespace {
// Route row ids to owning servers (searchsorted over offsets).
std::vector<std::vector<int64_t>> route_rows(const MvTable* t,
                                             const int* row_ids,
                                             long long n) {
  std::vector<std::vector<int64_t>> by_server(t->offsets.size() - 1);
  for (long long i = 0; i < n; ++i) {
    int64_t r = row_ids[i];
    size_t s = by_server.size() - 1;
    for (size_t j = 0; j + 1 < t->offsets.size(); ++j) {
      if (r >= t->offsets[j] && r < t->offsets[j + 1]) {
        s = j;
        break;
      }
    }
    by_server[s].push_back(i);
  }
  return by_server;
}
}  // namespace

int MV_AddMatrixTableByRows(void* table, const float* deltas,
                            const int* row_ids, long long n) {
  auto* t = static_cast<MvTable*>(table);
  if (!t || t->kind != kMatrix) return -1;
  auto by_server = route_rows(t, row_ids, n);
  for (size_t s = 0; s < by_server.size(); ++s) {
    const auto& ix = by_server[s];
    if (ix.empty()) continue;
    std::vector<int32_t> keys;
    std::vector<float> piece;
    for (int64_t i : ix) {
      keys.push_back(row_ids[i]);
      const float* row = deltas + i * t->cols;
      piece.insert(piece.end(), row, row + t->cols);
    }
    Msg m, reply;
    m.type = kRequestAdd;
    m.table_id = t->table_id;
    m.blobs.push_back(make_blob<int32_t>(
        "<i4", keys.data(), static_cast<int64_t>(keys.size())));
    m.blobs.push_back(opt_blob());
    m.blobs.push_back(
        marker_blob({static_cast<int64_t>(keys.size()), t->cols}));
    m.blobs.push_back(make_blob<float>(
        "<f4", piece.data(), static_cast<int64_t>(piece.size()), t->cols));
    if (!round_trip(t->client, static_cast<int>(s), &m, &reply)) return -2;
  }
  return 0;
}

int MV_GetMatrixTableByRows(void* table, float* data, const int* row_ids,
                            long long n) {
  auto* t = static_cast<MvTable*>(table);
  if (!t || t->kind != kMatrix) return -1;
  auto by_server = route_rows(t, row_ids, n);
  std::vector<float> scratch;
  for (size_t s = 0; s < by_server.size(); ++s) {
    const auto& ix = by_server[s];
    if (ix.empty()) continue;
    std::vector<int32_t> keys;
    for (int64_t i : ix) keys.push_back(row_ids[i]);
    Msg m, reply;
    m.type = kRequestGet;
    m.table_id = t->table_id;
    m.blobs.push_back(make_blob<int32_t>(
        "<i4", keys.data(), static_cast<int64_t>(keys.size())));
    if (!round_trip(t->client, static_cast<int>(s), &m, &reply)) return -2;
    scratch.assign(static_cast<size_t>(ix.size()) * t->cols, 0.f);
    if (!decode_payload(reply.blobs, 0, scratch.data(),
                        static_cast<int64_t>(scratch.size())))
      return -3;
    for (size_t j = 0; j < ix.size(); ++j)
      std::memcpy(data + ix[j] * t->cols, scratch.data() + j * t->cols,
                  static_cast<size_t>(t->cols) * sizeof(float));
  }
  return 0;
}

// -- KV table (ref include/multiverso/table/kv_table.h:42-66) ------------
int MV_NewKVTable(void* client, int table_id, void** out_table) {
  auto* c = static_cast<MvClient*>(client);
  if (!c || !out_table) return -1;
  auto* t = new MvTable{c, table_id, 0, 1, kKV, {}};
  *out_table = t;
  return 0;
}

int MV_AddKVTable(void* table, const long long* keys,
                  const long long* values, long long n) {
  auto* t = static_cast<MvTable*>(table);
  if (!t || t->kind != kKV) return -1;
  int world = static_cast<int>(t->client->fds.size());
  for (int s = 0; s < world; ++s) {
    std::vector<int64_t> ks, vs;
    for (long long i = 0; i < n; ++i) {
      if (keys[i] < 0) return -4;  // negative keys are wire sentinels
      if (keys[i] % world == s) {
        ks.push_back(keys[i]);
        vs.push_back(values[i]);
      }
    }
    if (ks.empty()) continue;
    Msg m, reply;
    m.type = kRequestAdd;
    m.table_id = t->table_id;
    m.blobs.push_back(make_blob<int64_t>(
        "<i8", ks.data(), static_cast<int64_t>(ks.size())));
    m.blobs.push_back(opt_blob());
    m.blobs.push_back(make_blob<int64_t>(
        "<i8", vs.data(), static_cast<int64_t>(vs.size())));
    if (!round_trip(t->client, s, &m, &reply)) return -2;
  }
  return 0;
}

int MV_GetKVTable(void* table, const long long* keys, long long* values,
                  long long n) {
  auto* t = static_cast<MvTable*>(table);
  if (!t || t->kind != kKV) return -1;
  int world = static_cast<int>(t->client->fds.size());
  for (int s = 0; s < world; ++s) {
    std::vector<int64_t> ks, pos;
    for (long long i = 0; i < n; ++i) {
      if (keys[i] < 0) return -4;
      if (keys[i] % world == s) {
        ks.push_back(keys[i]);
        pos.push_back(i);
      }
    }
    if (ks.empty()) continue;
    Msg m, reply;
    m.type = kRequestGet;
    m.table_id = t->table_id;
    m.blobs.push_back(make_blob<int64_t>(
        "<i8", ks.data(), static_cast<int64_t>(ks.size())));
    if (!round_trip(t->client, s, &m, &reply)) return -2;
    if (reply.blobs.empty() || reply.blobs[0].dtype != "<i8") return -3;
    const int64_t* vals =
        reinterpret_cast<const int64_t*>(reply.blobs[0].raw.data());
    for (size_t j = 0; j < pos.size() && j < reply.blobs[0].raw.size() / 8;
         ++j)
      values[pos[j]] = vals[j];
  }
  return 0;
}

void MV_FreeTable(void* table) { delete static_cast<MvTable*>(table); }

}  // extern "C"
