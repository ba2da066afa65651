// UDP packet source: non-blocking dual-socket receiver with a poll loop —
// the live-sensor transport (role of the reference SDK client,
// ouster_client/src/client.cpp:39-601: init_client/poll_client/
// read_lidar_packet), redesigned as a self-contained receiver thread that
// drains both sockets into ring buffers (native ring_buffer.cpp) instead of
// exposing select() to the caller.
//
// C ABI: create(lidar_port, imu_port, lidar_size, imu_size, depth) ->
// handle; read_{lidar,imu}(handle, out, timeout_ms); destroy. Packets are
// length-prefixed inside slots so short datagrams are preserved.

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/select.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
void* nst_ring_create(size_t item_size, size_t capacity);
void nst_ring_destroy(void* rb);
int nst_ring_write_overwrite(void* rb, const uint8_t* item);
int nst_ring_read(void* rb, uint8_t* out, long timeout_ms);
}

namespace {

struct UdpSource {
    int lidar_fd = -1;
    int imu_fd = -1;
    size_t lidar_size = 0;
    size_t imu_size = 0;
    void* lidar_ring = nullptr;
    void* imu_ring = nullptr;
    std::atomic<bool> running{false};
    std::atomic<uint64_t> lidar_dropped{0};
    std::atomic<uint64_t> imu_dropped{0};
    std::thread worker;
    std::vector<uint8_t> scratch;

    void loop() {
        while (running.load(std::memory_order_relaxed)) {
            fd_set rfds;
            FD_ZERO(&rfds);
            int maxfd = -1;
            for (int fd : {lidar_fd, imu_fd}) {
                if (fd >= 0) {
                    FD_SET(fd, &rfds);
                    if (fd > maxfd) maxfd = fd;
                }
            }
            timeval tv{0, 50 * 1000};  // 50 ms poll tick
            int rc = select(maxfd + 1, &rfds, nullptr, nullptr, &tv);
            if (rc <= 0) continue;
            if (lidar_fd >= 0 && FD_ISSET(lidar_fd, &rfds))
                drain(lidar_fd, lidar_ring, lidar_size, lidar_dropped);
            if (imu_fd >= 0 && FD_ISSET(imu_fd, &rfds))
                drain(imu_fd, imu_ring, imu_size, imu_dropped);
        }
    }

    void drain(int fd, void* ring, size_t size,
               std::atomic<uint64_t>& dropped) {
        // slot layout: [u32 length][payload]
        for (;;) {
            ssize_t n = recv(fd, scratch.data() + 4, scratch.size() - 4, 0);
            if (n <= 0) break;
            if (static_cast<size_t>(n) > size) n = size;
            uint32_t len = static_cast<uint32_t>(n);
            std::memcpy(scratch.data(), &len, 4);
            dropped += nst_ring_write_overwrite(ring, scratch.data());
        }
    }
};

// mcast_group: optional dotted-quad multicast group to join (the SDK's
// MTP / multiple-topic mode, client.cpp mtp_init_client: several hosts
// subscribe to one sensor stream); nullptr/empty for plain unicast.
int open_udp(int port, const char* mcast_group) {
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    int rcvbuf = 4 * 1024 * 1024;
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
        close(fd);
        return -1;
    }
    if (mcast_group != nullptr && mcast_group[0] != '\0') {
        ip_mreq mreq{};
        if (inet_pton(AF_INET, mcast_group, &mreq.imr_multiaddr) != 1) {
            close(fd);
            return -1;
        }
        mreq.imr_interface.s_addr = htonl(INADDR_ANY);
        if (setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq,
                       sizeof(mreq)) < 0) {
            close(fd);
            return -1;
        }
    }
    fcntl(fd, F_SETFL, O_NONBLOCK);
    return fd;
}

}  // namespace

extern "C" {

void* nst_udp_create_mtp(int lidar_port, int imu_port, size_t lidar_size,
                         size_t imu_size, size_t depth,
                         const char* mcast_group) {
    auto* src = new UdpSource();
    src->lidar_size = lidar_size;
    src->imu_size = imu_size;
    src->lidar_fd = lidar_port > 0 ? open_udp(lidar_port, mcast_group) : -1;
    src->imu_fd = imu_port > 0 ? open_udp(imu_port, mcast_group) : -1;
    if ((lidar_port > 0 && src->lidar_fd < 0)
        || (imu_port > 0 && src->imu_fd < 0)) {
        delete src;
        return nullptr;
    }
    src->lidar_ring = nst_ring_create(4 + lidar_size, depth);
    src->imu_ring = nst_ring_create(4 + imu_size, depth);
    src->scratch.resize(4 + std::max(lidar_size, imu_size));
    src->running = true;
    src->worker = std::thread([src] { src->loop(); });
    return src;
}

void* nst_udp_create(int lidar_port, int imu_port, size_t lidar_size,
                     size_t imu_size, size_t depth) {
    return nst_udp_create_mtp(lidar_port, imu_port, lidar_size, imu_size,
                              depth, nullptr);
}

void nst_udp_destroy(void* h) {
    auto* src = static_cast<UdpSource*>(h);
    src->running = false;
    if (src->worker.joinable()) src->worker.join();
    if (src->lidar_fd >= 0) close(src->lidar_fd);
    if (src->imu_fd >= 0) close(src->imu_fd);
    nst_ring_destroy(src->lidar_ring);
    nst_ring_destroy(src->imu_ring);
    delete src;
}

// Returns payload length (>0), 0 on timeout.
int nst_udp_read_lidar(void* h, uint8_t* out, long timeout_ms) {
    auto* src = static_cast<UdpSource*>(h);
    std::vector<uint8_t> slot(4 + src->lidar_size);
    if (nst_ring_read(src->lidar_ring, slot.data(), timeout_ms)) return 0;
    uint32_t len;
    std::memcpy(&len, slot.data(), 4);
    std::memcpy(out, slot.data() + 4, len);
    return static_cast<int>(len);
}

// Drain up to max_n lidar packets into a contiguous buffer (stride =
// lidar_size, short datagrams zero-padded). Blocks up to timeout_ms for
// the FIRST packet, then drains whatever is queued without blocking — one
// C call per poll instead of one per packet (the per-packet Python/ctypes
// hop is the live path's overhead at 2048x20 rates; see
// runtime/live.LiveDriver.poll_once).
int nst_udp_read_lidar_many(void* h, uint8_t* out, int max_n,
                            long timeout_ms) {
    auto* src = static_cast<UdpSource*>(h);
    std::vector<uint8_t> slot(4 + src->lidar_size);
    int n = 0;
    while (n < max_n) {
        long t = (n == 0) ? timeout_ms : 0;
        if (nst_ring_read(src->lidar_ring, slot.data(), t)) break;
        uint32_t len;
        std::memcpy(&len, slot.data(), 4);
        uint8_t* dst = out + static_cast<size_t>(n) * src->lidar_size;
        std::memcpy(dst, slot.data() + 4, len);
        if (len < src->lidar_size)
            std::memset(dst + len, 0, src->lidar_size - len);
        ++n;
    }
    return n;
}

int nst_udp_read_imu(void* h, uint8_t* out, long timeout_ms) {
    auto* src = static_cast<UdpSource*>(h);
    std::vector<uint8_t> slot(4 + src->imu_size);
    if (nst_ring_read(src->imu_ring, slot.data(), timeout_ms)) return 0;
    uint32_t len;
    std::memcpy(&len, slot.data(), 4);
    std::memcpy(out, slot.data() + 4, len);
    return static_cast<int>(len);
}

uint64_t nst_udp_lidar_dropped(void* h) {
    return static_cast<UdpSource*>(h)->lidar_dropped.load();
}

}  // extern "C"
