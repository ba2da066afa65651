// Batch Ouster lidar-packet parser — native host fast path for live ingest.
//
// Parses N packets into contiguous column-major field arrays in one call
// (the role of the reference SDK's per-packet packet_format accessors +
// ScanBatcher inner loop, ouster_client/src/parsing.cpp:190-260 and
// lidar_scan.cpp:540-678, re-done as a flat batch kernel rather than a
// per-field callback table). C ABI for ctypes; layouts match
// noetic_slam_tpu_torch/io/ouster.py PacketFormat.

#include <cstdint>
#include <cstring>

namespace {

struct Geometry {
    int legacy;      // 1 = LEGACY profile
    int h;           // pixels per column
    int cols;        // columns per packet
    int chan;        // channel data size (12 single/legacy, 16 dual)
    int packet_header;
    int col_header;
    int col_footer;
    int col_size;
};

inline Geometry make_geom(int legacy, int h, int cols, int chan) {
    Geometry g;
    g.legacy = legacy;
    g.h = h;
    g.cols = cols;
    g.chan = chan;
    g.packet_header = legacy ? 0 : 32;
    g.col_header = legacy ? 16 : 12;
    g.col_footer = legacy ? 4 : 0;
    g.col_size = g.col_header + h * chan + g.col_footer;
    return g;
}

template <typename T>
inline T rd(const uint8_t* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;
}

}  // namespace

extern "C" {

// Parse n_packets (each packet_size bytes, back-to-back in `buf`) into
// flat outputs indexed [packet * cols + col] for headers and
// [row * (n_packets * cols) + packet * cols + col] for pixel fields.
// Returns the number of columns written.
int nst_parse_lidar_packets(const uint8_t* buf, int n_packets,
                            int packet_size, int legacy, int h,
                            int cols_per_packet, int chan,
                            uint64_t* ts, uint16_t* m_id, uint8_t* status,
                            uint16_t* frame_id, uint32_t* range,
                            uint16_t* signal, uint16_t* reflectivity,
                            uint16_t* near_ir) {
    const Geometry g = make_geom(legacy, h, cols_per_packet, chan);
    const int total_cols = n_packets * g.cols;
    const uint32_t range_mask = legacy ? 0x000FFFFFu : 0x0007FFFFu;

    for (int p = 0; p < n_packets; ++p) {
        const uint8_t* pkt = buf + static_cast<size_t>(p) * packet_size;
        uint16_t fid;
        if (legacy) {
            fid = rd<uint16_t>(pkt + 10);  // first column header
        } else {
            fid = rd<uint16_t>(pkt + 2);
        }
        for (int c = 0; c < g.cols; ++c) {
            const uint8_t* col = pkt + g.packet_header + c * g.col_size;
            const int oc = p * g.cols + c;
            ts[oc] = rd<uint64_t>(col);
            m_id[oc] = rd<uint16_t>(col + 8);
            frame_id[oc] = fid;
            if (legacy) {
                uint32_t foot =
                    rd<uint32_t>(col + g.col_size - g.col_footer);
                status[oc] = foot == 0xFFFFFFFFu ? 1 : 0;
            } else {
                status[oc] = rd<uint16_t>(col + 10) & 1;
            }
            const uint8_t* px0 = col + g.col_header;
            for (int u = 0; u < g.h; ++u) {
                const uint8_t* px = px0 + u * g.chan;
                const size_t oi =
                    static_cast<size_t>(u) * total_cols + oc;
                if (chan == 4) {          // RNG15_RFL8_NIR8 low bandwidth
                    range[oi] = (rd<uint16_t>(px) & 0x7FFFu) << 3;
                    reflectivity[oi] = px[2];
                    signal[oi] = 0;
                    near_ir[oi] = static_cast<uint16_t>(px[3]) << 4;
                    continue;
                }
                range[oi] = rd<uint32_t>(px) & range_mask;
                if (legacy) {
                    reflectivity[oi] = rd<uint16_t>(px + 4);
                    signal[oi] = rd<uint16_t>(px + 6);
                    near_ir[oi] = rd<uint16_t>(px + 8);
                } else if (chan == 12) {  // RNG19 single return
                    reflectivity[oi] = px[4];
                    signal[oi] = rd<uint16_t>(px + 6);
                    near_ir[oi] = rd<uint16_t>(px + 8);
                } else {                  // RNG19 dual (16 B) and
                    reflectivity[oi] = px[3];   // FIVE_WORD_PIXEL (20 B):
                    signal[oi] = rd<uint16_t>(px + 8);   // same first-return
                    near_ir[oi] = rd<uint16_t>(px + 12); // word layout
                }
            }
        }
    }
    return total_cols;
}

// Parse one 48-byte IMU packet: ts_ns, accel (g), gyro (deg/s).
void nst_parse_imu_packet(const uint8_t* buf, uint64_t* ts, float* la,
                          float* av) {
    *ts = rd<uint64_t>(buf);
    for (int i = 0; i < 3; ++i) la[i] = rd<float>(buf + 24 + 4 * i);
    for (int i = 0; i < 3; ++i) av[i] = rd<float>(buf + 36 + 4 * i);
}

}  // extern "C"
