// JPEG 2000 (ISO/IEC 15444-1) reader of the service's image codec
// (onnxocr_tpu_torch/utils/imcodec.py): what cv2.imdecode(buf,
// IMREAD_COLOR) computes through OpenJPEG 2.5, on a machine without cv2.
//
// * Containers: the JP2 box file (signature, ftyp, jp2h with ihdr, colr,
//   pclr, cmap and cdef; jp2c) and the bare codestream (FF 4F FF 51).
// * Codestream: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT in the main and
//   tile-part headers, applied in codestream order (TLM, PLM, PLT, CRG,
//   COM, CAP, CPF checked and read past), with OpenJPEG's marker table:
//   where each marker may stand, an unknown main-header segment skipped
//   two bytes at a time, an unknown tile-part marker a failure; several
//   tile-parts a tile, SOP/EPH, the five progression orders, precincts,
//   layers and the packet headers' tag trees, as OpenJPEG's t2.c and pi.c
//   read them. Part 2 transforms (MCT, MCC, MCO, CBD) and Part 15 (HT)
//   code-blocks give None here; OpenJPEG reads them.
// * Tier 1: the MQ decoder and the significance, refinement and cleanup
//   passes with every code-block style (bypass, reset, termall, vertically
//   causal, predictable termination, segmentation symbols), OpenJPEG's
//   reconstruction in the middle of the last decoded bit-plane (one
//   fractional bit), ROI max-shift.
// * Dequantisation (none, scalar derived, scalar expounded), the 5/3
//   integer and 9/7 float inverse wavelets in OpenJPEG's arithmetic (its
//   lifting constants and order, the 2/K high-pass scale compensated in
//   the step sizes), RCT / ICT, the DC level shift with lrintf and the
//   clip to the component's range.
// * cv2 5.0's side: signed components, a largest precision below 8,
//   an image or component origin other than 0 and subsampled
//   components give None; samples are shifted right by (largest precision
//   - 8) and cast; sRGB (and an unknown or unspecified colour space, as
//   cv2 assumes sRGB) needs three components and drops the rest, grey
//   replicates the first, sYCC goes through cv2's 8-bit YUV -> BGR.
//   A truncated codestream, one without EOC or any structural error gives
//   None, as OpenJPEG's strict mode fails the decode.
//
// Each tile is decoded on its own into the output, so a decode holds the
// compressed bytes, the output and one tile's coefficients.
//
// Built at first use by ops/native.py: g++ -std=c++17 -shared -fPIC -O2

// no fused multiply-add: OpenJPEG's lifting and ICT round each product
#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <stdexcept>
#include <vector>

namespace {

struct Fail : std::runtime_error {
    Fail() : std::runtime_error("jpeg2000") {}
};

[[noreturn]] void fail() { throw Fail(); }

inline uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | p[3];
}

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int32_t ceildivpow2(int32_t a, int b) {
    return int32_t((int64_t(a) + (int64_t(1) << b) - 1) >> b);
}
inline int32_t floordivpow2(int32_t a, int b) { return a >> b; }

// ---------------------------------------------------------------- headers
struct CompSiz {
    int prec = 0;
    bool sgnd = false;
    int dx = 1, dy = 1;
};

struct CompStyle {  // SPcod / SPcoc
    int numres = 0;
    int cblkw = 0, cblkh = 0;
    int cblksty = 0;
    int qmfbid = 0;
    int prcw[33], prch[33];
};

struct Quant {  // SQcd / SQcc
    int qntsty = 0;
    int numgbits = 0;
    int expn[97], mant[97];
};

struct Poc {
    int resno0, compno0, layno1, resno1, compno1, prg;
};

// The coding parameters of the main header (OpenJPEG's default tcp) or of
// one tile (its tcp, a copy of the main header's at the tile's first
// marker that changes them). Markers apply in codestream order: COD and
// QCD set every component, COC and QCC one, as OpenJPEG copies them.
struct Params {
    int csty = 0, prg = 0, numlayers = 0, mct = 0;
    bool cod = false;  // a COD read
    std::vector<CompStyle> style;
    std::vector<Quant> quant;
    std::vector<int> roishift;
    std::vector<Poc> poc;
};

struct Span {
    const uint8_t* p;
    size_t n;
};

struct TileHeader {
    std::unique_ptr<Params> own;  // null: the main header's
    std::vector<Span> parts;               // tile-part bodies
    std::vector<std::pair<int, Span>> ppt; // (Zppt, data)
    std::vector<std::pair<size_t, size_t>> ppm;  // Nppm chunks (offset, n)
    int nparts = 0;
    int tnsot = 0;         // tile-parts announced, 0: unknown
    bool decoded = false;
};

struct Codestream {
    uint32_t Xsiz = 0, Ysiz = 0, XOsiz = 0, YOsiz = 0;
    uint32_t XTsiz = 0, YTsiz = 0, XTOsiz = 0, YTOsiz = 0;
    int numcomps = 0;
    std::vector<CompSiz> comps;
    uint32_t tw = 0, th = 0;  // tiles across and down
    Params main;
    bool has_qcd = false;
    bool ppm = false;
    std::vector<std::pair<int, Span>> ppm_segs;
    std::vector<uint8_t> ppm_all;  // PPM data in Zppm order
    std::vector<TileHeader> tiles;

    const Params& params(int t) const {
        return tiles[t].own ? *tiles[t].own : main;
    }
};

struct Stream {
    const uint8_t* p;
    size_t n;
    size_t pos = 0;
    Stream(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
    uint32_t u8() {
        if (pos + 1 > n) fail();
        return p[pos++];
    }
    uint32_t u16() {
        if (pos + 2 > n) fail();
        uint32_t v = be16(p + pos);
        pos += 2;
        return v;
    }
    uint32_t u32() {
        if (pos + 4 > n) fail();
        uint32_t v = be32(p + pos);
        pos += 4;
        return v;
    }
};

void read_siz(Codestream& cs, const uint8_t* d, size_t len) {
    if (len < 36) fail();
    cs.Xsiz = be32(d + 2);
    cs.Ysiz = be32(d + 6);
    cs.XOsiz = be32(d + 10);
    cs.YOsiz = be32(d + 14);
    cs.XTsiz = be32(d + 18);
    cs.YTsiz = be32(d + 22);
    cs.XTOsiz = be32(d + 26);
    cs.YTOsiz = be32(d + 30);
    cs.numcomps = int(be16(d + 34));
    if (cs.numcomps < 1 || cs.numcomps > 16384) fail();
    if (len != size_t(36 + 3 * cs.numcomps)) fail();
    if (cs.XOsiz >= cs.Xsiz || cs.YOsiz >= cs.Ysiz) fail();
    if (cs.XTsiz == 0 || cs.YTsiz == 0) fail();
    if (cs.XTOsiz > cs.XOsiz || cs.YTOsiz > cs.YOsiz) fail();
    if (uint64_t(cs.XTOsiz) + cs.XTsiz <= cs.XOsiz ||
        uint64_t(cs.YTOsiz) + cs.YTsiz <= cs.YOsiz)
        fail();
    cs.comps.resize(cs.numcomps);
    for (int i = 0; i < cs.numcomps; ++i) {
        const uint8_t* c = d + 36 + 3 * i;
        cs.comps[i].prec = (c[0] & 0x7f) + 1;
        cs.comps[i].sgnd = (c[0] >> 7) != 0;
        cs.comps[i].dx = c[1];
        cs.comps[i].dy = c[2];
        if (cs.comps[i].dx < 1 || cs.comps[i].dy < 1) fail();
        if (cs.comps[i].prec > 31) fail();
    }
    uint64_t tw = ceildiv(int64_t(cs.Xsiz) - cs.XTOsiz, cs.XTsiz);
    uint64_t th = ceildiv(int64_t(cs.Ysiz) - cs.YTOsiz, cs.YTsiz);
    if (tw == 0 || th == 0 || tw * th > 65535) fail();
    cs.tw = uint32_t(tw);
    cs.th = uint32_t(th);
    cs.main.style.resize(cs.numcomps);
    cs.main.quant.resize(cs.numcomps);
    cs.main.roishift.assign(cs.numcomps, 0);
    cs.tiles.resize(size_t(tw * th));
}

// SPcod / SPcoc from d[0..len); `precincts` from Scod / Scoc bit 0
size_t read_comp_style(CompStyle& s, const uint8_t* d, size_t len,
                       bool precincts) {
    if (len < 5) fail();
    s.numres = d[0] + 1;
    if (s.numres > 33) fail();
    s.cblkw = (d[1] & 0xf) + 2;
    s.cblkh = (d[2] & 0xf) + 2;
    if (d[1] > 8 || d[2] > 8 || s.cblkw + s.cblkh > 12) fail();
    s.cblksty = d[3];
    if (s.cblksty & 0xC0) fail();  // HT code-blocks (Part 15) and above
    s.qmfbid = d[4];
    if (s.qmfbid > 1) fail();
    size_t used = 5;
    for (int r = 0; r < s.numres; ++r) {
        if (precincts) {
            if (used >= len) fail();
            s.prcw[r] = d[used] & 0xf;
            s.prch[r] = d[used] >> 4;
            if (r > 0 && (s.prcw[r] == 0 || s.prch[r] == 0)) fail();
            ++used;
        } else {
            s.prcw[r] = 15;
            s.prch[r] = 15;
        }
    }
    return used;
}

int comp_index(const Codestream& cs, const uint8_t* d, size_t len,
               int& room) {
    room = cs.numcomps <= 256 ? 1 : 2;
    if (len < size_t(room)) fail();
    int c = room == 1 ? d[0] : int(be16(d));
    if (c >= cs.numcomps) fail();
    return c;
}

void read_cod(Params& pm, const uint8_t* d, size_t len) {
    if (len < 5) fail();
    pm.csty = d[0];
    if (pm.csty & ~0x07) fail();
    pm.prg = d[1];
    if (pm.prg > 4) fail();
    pm.numlayers = int(be16(d + 2));
    if (pm.numlayers < 1) fail();
    pm.mct = d[4];
    if (pm.mct > 1) fail();
    CompStyle s;
    size_t used = read_comp_style(s, d + 5, len - 5, pm.csty & 1);
    if (used + 5 != len) fail();
    std::fill(pm.style.begin(), pm.style.end(), s);
    pm.cod = true;
}

void read_coc(const Codestream& cs, Params& pm, const uint8_t* d,
              size_t len) {
    int room;
    int c = comp_index(cs, d, len, room);
    if (len < size_t(room + 1)) fail();
    size_t used = read_comp_style(pm.style[c], d + room + 1, len - room - 1,
                                  d[room] & 1);
    if (used + room + 1 != len) fail();
}

// opj_j2k_read_SQcd_SQcc: a style other than none or scalar derived reads
// as expounded; the segment must hold exactly its step sizes
void read_quant(Quant& q, const uint8_t* d, size_t len) {
    if (len < 1) fail();
    q.qntsty = d[0] & 0x1f;
    q.numgbits = d[0] >> 5;
    size_t n;
    if (q.qntsty == 0) {
        n = std::min<size_t>(len - 1, 97);
        for (size_t b = 0; b < n; ++b) {
            q.expn[b] = d[1 + b] >> 3;
            q.mant[b] = 0;
        }
    } else if (q.qntsty == 1) {
        if (len != 3) fail();
        n = 1;
        uint32_t v = be16(d + 1);
        q.expn[0] = int(v >> 11);
        q.mant[0] = int(v & 0x7ff);
    } else {
        if ((len - 1) % 2) fail();
        n = std::min<size_t>((len - 1) / 2, 97);
        for (size_t b = 0; b < n; ++b) {
            uint32_t v = be16(d + 1 + 2 * b);
            q.expn[b] = int(v >> 11);
            q.mant[b] = int(v & 0x7ff);
        }
    }
    if (q.qntsty == 1) {
        for (int b = 1; b < 97; ++b) {
            q.expn[b] = std::max(q.expn[0] - (b - 1) / 3, 0);
            q.mant[b] = q.mant[0];
        }
    } else {
        for (size_t b = n; b < 97; ++b) {
            q.expn[b] = 0;
            q.mant[b] = 0;
        }
    }
}

void read_qcd(Params& pm, const uint8_t* d, size_t len) {
    Quant q;
    read_quant(q, d, len);
    std::fill(pm.quant.begin(), pm.quant.end(), q);
}

void read_qcc(const Codestream& cs, Params& pm, const uint8_t* d,
              size_t len) {
    int room;
    int c = comp_index(cs, d, len, room);
    read_quant(pm.quant[c], d + room, len - room);
}

void read_rgn(const Codestream& cs, Params& pm, const uint8_t* d,
              size_t len) {
    int room;
    int c = comp_index(cs, d, len, room);
    if (len != size_t(room + 2)) fail();
    pm.roishift[c] = d[room + 1];  // SPrgn; Srgn is not read
}

void read_poc(const Codestream& cs, Params& pm, const uint8_t* d,
              size_t len) {
    int room = cs.numcomps <= 256 ? 1 : 2;
    size_t one = 5 + 2 * size_t(room);
    if (len == 0 || len % one) fail();
    if (pm.poc.size() + len / one > 32) fail();  // J2K_MAX_POCS
    for (size_t i = 0; i < len / one; ++i) {
        const uint8_t* e = d + i * one;
        Poc p;
        p.resno0 = e[0];
        p.compno0 = room == 1 ? e[1] : int(be16(e + 1));
        p.layno1 = int(be16(e + 1 + room));
        p.resno1 = std::min(int(e[3 + room]), 33);
        p.compno1 = room == 1 ? e[4 + room] : int(be16(e + 4 + room));
        p.compno1 = std::min(p.compno1, cs.numcomps);
        p.prg = e[4 + 2 * room];
        if (p.prg > 4) fail();
        pm.poc.push_back(p);
    }
}

// PLT: every packet length ends in a byte without its continuation bit
void read_plt(const uint8_t* d, size_t len) {
    if (len < 1) fail();
    uint32_t pending = 0;
    for (size_t i = 1; i < len; ++i) pending = (d[i] & 0x80) ? 1 : 0;
    if (pending) fail();
}

// OpenJPEG's marker table: where each known marker may stand
enum : int { S_MHSIZ = 1, S_MH = 2, S_TPHSOT = 4, S_TPH = 8 };
int marker_states(uint32_t m) {
    switch (m) {
    case 0xFF90: return S_MH | S_TPHSOT;                        // SOT
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D:
    case 0xFF5F: case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77:
        return S_MH | S_TPH;       // COD COC RGN QCD QCC POC COM MCT MCC MCO
    case 0xFF51: return S_MHSIZ;                                // SIZ
    case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78:
    case 0xFF50: case 0xFF59:
        return S_MH;                   // TLM PLM PPM CRG CBD CAP CPF
    case 0xFF58: case 0xFF61: return S_TPH;                     // PLT PPT
    case 0xFF91: return 0;                                      // SOP
    default: return -1;                                         // unknown
    }
}

// opj_j2k_read_unk: past an unknown marker, the next known one two bytes
// at a time (it must be allowed where it stands)
uint32_t skip_unknown(Stream& s, int state) {
    for (;;) {
        uint32_t m = s.u16();
        if (m < 0xFF00) continue;
        int st = marker_states(m);
        if (st < 0) continue;
        if (!(st & state)) fail();
        return m;
    }
}

// One marker segment of a header into `pm` (the main header's or a
// tile's); segments that change nothing decoded are checked and passed.
void read_segment(Codestream& cs, Params& pm, uint32_t m, const uint8_t* d,
                  size_t l) {
    switch (m) {
    case 0xFF52: read_cod(pm, d, l); break;
    case 0xFF53: read_coc(cs, pm, d, l); break;
    case 0xFF5C:
        read_qcd(pm, d, l);
        cs.has_qcd = true;
        break;
    case 0xFF5D: read_qcc(cs, pm, d, l); break;
    case 0xFF5E: read_rgn(cs, pm, d, l); break;
    case 0xFF5F: read_poc(cs, pm, d, l); break;
    case 0xFF55: if (l < 2) fail(); break;  // TLM (its content is not read)
    case 0xFF57: if (l < 1) fail(); break;  // PLM
    case 0xFF58: read_plt(d, l); break;
    case 0xFF63: if (l != size_t(cs.numcomps) * 4) fail(); break;  // CRG
    case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78:
        fail();  // Part 2 multiple component transforms: not read
    default: break;  // COM, CAP, CPF
    }
}

// `on_tile(t)` decodes tile t; null reads the main header only. Tiles are
// decoded in OpenJPEG's order and its rules end the stream: a tile as soon
// as its announced tile-parts are read (or at its Psot = 0 tile-part),
// then the next two bytes must be SOT or EOC, or the last two of the
// stream; reading stops once every tile is decoded; the tiles left
// incomplete at EOC are decoded then.
void read_codestream(Codestream& cs, const uint8_t* p, size_t n,
                     const std::function<void(int)>& on_tile) {
    Stream s(p, n);
    if (s.u16() != 0xFF4F) fail();
    if (s.u16() != 0xFF51) fail();
    {
        uint32_t len = s.u16();
        if (len < 2 || s.pos + len - 2 > n) fail();
        read_siz(cs, p + s.pos, len - 2);
        s.pos += len - 2;
    }
    // main header
    for (uint32_t m = s.u16(); m != 0xFF90;) {
        if (m < 0xFF00) fail();
        int st = marker_states(m);
        if (st < 0) {
            m = skip_unknown(s, S_MH);
            if (m == 0xFF90) break;
            st = marker_states(m);
        }
        if (!(st & S_MH)) fail();
        uint32_t len = s.u16();
        if (len < 2 || s.pos + len - 2 > n) fail();
        const uint8_t* d = p + s.pos;
        size_t l = len - 2;
        if (m == 0xFF60) {  // PPM
            if (l < 2) fail();
            cs.ppm = true;
            cs.ppm_segs.push_back({d[0], Span{d + 1, l - 1}});
        } else {
            read_segment(cs, cs.main, m, d, l);
        }
        s.pos += l;
        m = s.u16();
    }
    if (!cs.main.cod || !cs.has_qcd) fail();
    if (!on_tile) return;

    // PPM: Nppm chunks in Zppm order, one per tile-part in codestream order
    size_t ppm_pos = 0;
    if (cs.ppm) {
        std::stable_sort(cs.ppm_segs.begin(), cs.ppm_segs.end(),
                         [](const std::pair<int, Span>& a,
                            const std::pair<int, Span>& b) {
                             return a.first < b.first;
                         });
        for (auto& sg : cs.ppm_segs)
            cs.ppm_all.insert(cs.ppm_all.end(), sg.second.p,
                              sg.second.p + sg.second.n);
    }
    const size_t ntiles = cs.tiles.size();
    size_t ndecoded = 0;
    auto decode = [&](TileHeader& t, size_t no) {
        if (t.decoded) return;
        t.decoded = true;
        ++ndecoded;
        on_tile(int(no));
    };
    // tile-parts; s.pos is past an SOT marker's code
    for (;;) {
        size_t sot = s.pos - 2;
        uint32_t len = s.u16();
        if (len != 10) fail();
        uint32_t isot = s.u16();
        uint32_t psot = s.u32();
        uint32_t tpsot = s.u8();
        uint32_t tnsot = s.u8();
        if (isot >= ntiles) fail();
        if (psot != 0 && psot < 14) fail();
        TileHeader& t = cs.tiles[isot];
        if (int(tpsot) != t.nparts) fail();
        if (tnsot) {
            if (int(tpsot) >= int(tnsot)) fail();
            t.tnsot = int(tnsot);
        }
        // Psot = 0: the data runs to the stream's last two bytes
        size_t end = psot ? sot + psot : (n >= 2 ? n - 2 : 0);
        if (end > n || end < s.pos) fail();
        // tile-part header: OpenJPEG reads no unknown marker here
        for (;;) {
            uint32_t m = s.u16();
            if (m == 0xFF93) break;  // SOD
            int st = marker_states(m);
            if (st < 0 || !(st & S_TPH)) fail();
            uint32_t ml = s.u16();
            if (ml < 2 || s.pos + ml - 2 > end) fail();
            const uint8_t* d = p + s.pos;
            size_t l = ml - 2;
            if (m == 0xFF61) {  // PPT
                if (l < 2 || cs.ppm) fail();
                t.ppt.push_back({d[0], Span{d + 1, l - 1}});
            } else if (m == 0xFF58 || m == 0xFF64) {
                read_segment(cs, cs.main, m, d, l);  // PLT, COM: checked
            } else {
                if (!t.own) t.own.reset(new Params(cs.main));
                read_segment(cs, *t.own, m, d, l);
            }
            s.pos += l;
        }
        if (s.pos > end) fail();
        t.parts.push_back(Span{p + s.pos, end - s.pos});
        if (cs.ppm) {
            if (ppm_pos + 4 > cs.ppm_all.size()) fail();
            uint32_t nppm = be32(cs.ppm_all.data() + ppm_pos);
            ppm_pos += 4;
            if (nppm > cs.ppm_all.size() - ppm_pos) fail();
            t.ppm.push_back({ppm_pos, nppm});
            ppm_pos += nppm;
        }
        t.nparts++;
        s.pos = end;
        bool complete = psot == 0 || (t.tnsot && t.nparts == t.tnsot);
        if (complete && !t.decoded) {
            decode(t, isot);
            if (n - s.pos < 2) fail();
            uint32_t m = be16(p + s.pos);
            s.pos += 2;
            if (m == 0xFFD9) break;
            if (m != 0xFF90) {
                if (s.pos == n) break;  // "does not end with EOC"
                fail();
            }
            if (ndecoded == ntiles) return;
        } else {
            if (n - s.pos < 2) fail();
            uint32_t m = be16(p + s.pos);
            s.pos += 2;
            if (m == 0xFFD9) break;
            if (m != 0xFF90) fail();
        }
        // a stream cut right after an SOT marker's code ends as at EOC
        if (s.pos == n) break;
    }
    for (size_t i = 0; i < ntiles; ++i)
        if (cs.tiles[i].nparts && !cs.tiles[i].decoded) decode(cs.tiles[i], i);
}

// ---------------------------------------------------------------- bit I/O
struct Bio {  // packet-header bits (opj_bio), with 0xFF bit stuffing
    const uint8_t* start;
    const uint8_t* bp;
    const uint8_t* end;
    uint32_t buf = 0;
    int ct = 0;
    Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return size_t(bp - start); }
};

struct TagTree {
    struct Node {
        int parent;
        int value;
        int low;
    };
    std::vector<Node> nodes;
    void init(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> lw, lh, base;
        int cw = w, ch = h, total = 0;
        for (;;) {
            lw.push_back(cw);
            lh.push_back(ch);
            base.push_back(total);
            total += cw * ch;
            if (cw * ch <= 1) break;
            cw = (cw + 1) / 2;
            ch = (ch + 1) / 2;
        }
        nodes.assign(total, Node{-1, 999, 0});
        for (size_t lv = 0; lv + 1 < lw.size(); ++lv)
            for (int j = 0; j < lh[lv]; ++j)
                for (int i = 0; i < lw[lv]; ++i)
                    nodes[base[lv] + j * lw[lv] + i].parent =
                        base[lv + 1] + (j / 2) * lw[lv + 1] + i / 2;
    }
    // opj_tgt_decode: 1 when the leaf's value is below `threshold`
    int decode(Bio& bio, int leaf, int threshold) {
        int stk[64];
        int sp = 0;
        int node = leaf;
        while (nodes[node].parent >= 0) {
            stk[sp++] = node;
            node = nodes[node].parent;
        }
        int low = 0;
        for (;;) {
            Node& nd = nodes[node];
            if (low > nd.low)
                nd.low = low;
            else
                low = nd.low;
            while (low < threshold && low < nd.value) {
                if (bio.bit())
                    nd.value = low;
                else
                    ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
        return nodes[node].value < threshold ? 1 : 0;
    }
};

// ---------------------------------------------------------------- tile
struct Seg {
    uint32_t len = 0;
    uint32_t numpasses = 0;
    uint32_t maxpasses = 0;
    uint32_t numnewpasses = 0;
    uint32_t newlen = 0;
};

struct Cblk {
    int x0, y0, x1, y1;
    uint32_t numbps = 0;
    uint32_t numlenbits = 0;
    uint32_t numnewpasses = 0;
    uint32_t numsegs = 0;
    std::vector<Seg> segs;
    std::vector<Span> chunks;
};

struct Prc {
    int x0, y0, x1, y1;
    int cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int bandno;  // 0: LL, 1: HL, 2: LH, 3: HH
    int x0, y0, x1, y1;
    int numbps;
    float stepsize;
    std::vector<Prc> prcs;
    bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Res {
    int x0, y0, x1, y1;
    int pw = 0, ph = 0;
    int pdx, pdy;
    int numbands;
    Band bands[3];
};

struct TileComp {
    int x0, y0, x1, y1;
    int numres;
    std::vector<Res> res;
    CompStyle style;
    Quant quant;
    int roishift = 0;
};

void init_tilecomp(TileComp& tc, const CompSiz& comp, int tx0, int ty0,
                   int tx1, int ty1) {
    tc.x0 = int(ceildiv(tx0, comp.dx));
    tc.y0 = int(ceildiv(ty0, comp.dy));
    tc.x1 = int(ceildiv(tx1, comp.dx));
    tc.y1 = int(ceildiv(ty1, comp.dy));
    const CompStyle& st = tc.style;
    tc.numres = st.numres;
    tc.res.resize(tc.numres);
    for (int r = 0; r < tc.numres; ++r) {
        Res& res = tc.res[r];
        int lev = tc.numres - 1 - r;
        res.x0 = ceildivpow2(tc.x0, lev);
        res.y0 = ceildivpow2(tc.y0, lev);
        res.x1 = ceildivpow2(tc.x1, lev);
        res.y1 = ceildivpow2(tc.y1, lev);
        res.pdx = st.prcw[r];
        res.pdy = st.prch[r];
        int tlx = floordivpow2(res.x0, res.pdx) << res.pdx;
        int tly = floordivpow2(res.y0, res.pdy) << res.pdy;
        int brx = ceildivpow2(res.x1, res.pdx) << res.pdx;
        int bry = ceildivpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : (brx - tlx) >> res.pdx;
        res.ph = res.y0 == res.y1 ? 0 : (bry - tly) >> res.pdy;
        if (int64_t(res.pw) * res.ph > (1 << 26)) fail();
        int cbgx, cbgy, cbgw, cbgh;
        if (r == 0) {
            cbgx = tlx;
            cbgy = tly;
            cbgw = res.pdx;
            cbgh = res.pdy;
            res.numbands = 1;
        } else {
            cbgx = ceildivpow2(tlx, 1);
            cbgy = ceildivpow2(tly, 1);
            cbgw = res.pdx - 1;
            cbgh = res.pdy - 1;
            res.numbands = 3;
        }
        int cbw = std::min(st.cblkw, cbgw);
        int cbh = std::min(st.cblkh, cbgh);
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            band.bandno = r == 0 ? 0 : b + 1;
            if (r == 0) {
                band.x0 = ceildivpow2(tc.x0, lev);
                band.y0 = ceildivpow2(tc.y0, lev);
                band.x1 = ceildivpow2(tc.x1, lev);
                band.y1 = ceildivpow2(tc.y1, lev);
            } else {
                int xob = band.bandno & 1, yob = band.bandno >> 1;
                int nb = lev + 1;
                band.x0 = int((int64_t(tc.x0) - (int64_t(xob) << (nb - 1)) +
                               (int64_t(1) << nb) - 1) >> nb);
                band.y0 = int((int64_t(tc.y0) - (int64_t(yob) << (nb - 1)) +
                               (int64_t(1) << nb) - 1) >> nb);
                band.x1 = int((int64_t(tc.x1) - (int64_t(xob) << (nb - 1)) +
                               (int64_t(1) << nb) - 1) >> nb);
                band.y1 = int((int64_t(tc.y1) - (int64_t(yob) << (nb - 1)) +
                               (int64_t(1) << nb) - 1) >> nb);
            }
            int sidx = r == 0 ? 0 : 3 * (r - 1) + b + 1;
            int expn = tc.quant.expn[sidx], mant = tc.quant.mant[sidx];
            // OpenJPEG's decoder drops the sub-band gain for the 9/7: its
            // inverse scales the high-pass by 2/K instead of 1/K
            int log2_gain = st.qmfbid == 0 ? 0
                            : band.bandno == 0 ? 0
                            : band.bandno == 3 ? 2 : 1;
            int rb = comp.prec + log2_gain;
            band.stepsize = float((1.0 + mant / 2048.0) *
                                  std::pow(2.0, double(rb - expn)));
            band.numbps = expn + tc.quant.numgbits - 1;
            int nprec = res.pw * res.ph;
            band.prcs.resize(nprec);
            for (int pno = 0; pno < nprec; ++pno) {
                Prc& prc = band.prcs[pno];
                int sx = cbgx + (pno % res.pw) * (1 << cbgw);
                int sy = cbgy + (pno / res.pw) * (1 << cbgh);
                prc.x0 = std::max(sx, band.x0);
                prc.y0 = std::max(sy, band.y0);
                prc.x1 = std::min(sx + (1 << cbgw), band.x1);
                prc.y1 = std::min(sy + (1 << cbgh), band.y1);
                int tcx = floordivpow2(prc.x0, cbw) << cbw;
                int tcy = floordivpow2(prc.y0, cbh) << cbh;
                int bcx = ceildivpow2(prc.x1, cbw) << cbw;
                int bcy = ceildivpow2(prc.y1, cbh) << cbh;
                prc.cw = std::max(0, (bcx - tcx) >> cbw);
                prc.ch = std::max(0, (bcy - tcy) >> cbh);
                if (prc.x1 <= prc.x0 || prc.y1 <= prc.y0) prc.cw = prc.ch = 0;
                if (band.empty()) prc.cw = prc.ch = 0;
                prc.cblks.resize(size_t(prc.cw) * prc.ch);
                for (int c = 0; c < prc.cw * prc.ch; ++c) {
                    Cblk& cb = prc.cblks[c];
                    int cx = tcx + (c % prc.cw) * (1 << cbw);
                    int cy = tcy + (c / prc.cw) * (1 << cbh);
                    cb.x0 = std::max(cx, prc.x0);
                    cb.y0 = std::max(cy, prc.y0);
                    cb.x1 = std::min(cx + (1 << cbw), prc.x1);
                    cb.y1 = std::min(cy + (1 << cbh), prc.y1);
                }
                prc.incl.init(prc.cw, prc.ch);
                prc.imsb.init(prc.cw, prc.ch);
            }
        }
    }
}

// opj_t2_init_seg
void init_seg(Cblk& cb, uint32_t index, int cblksty, bool first) {
    if (cb.segs.size() <= index) cb.segs.resize(index + 1);
    Seg& seg = cb.segs[index];
    seg = Seg();
    if (cblksty & 0x04) {  // TERMALL
        seg.maxpasses = 1;
    } else if (cblksty & 0x01) {  // LAZY (bypass)
        if (first) {
            seg.maxpasses = 10;
        } else {
            uint32_t prev = cb.segs[index - 1].maxpasses;
            seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        seg.maxpasses = 109;
    }
}

uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) {
        a >>= 1;
        ++l;
    }
    return l;
}

struct HeaderSource {  // where packet headers are read from
    const uint8_t* p;
    size_t n;
    size_t pos;
};

// One packet: its header (from `hs`) and its body (from `body`).
void read_packet(std::vector<TileComp>& tcs, int compno, int resno, int precno,
                 int layno, int csty, HeaderSource& hs, HeaderSource& body,
                 bool separate_headers) {
    TileComp& tc = tcs[compno];
    Res& res = tc.res[resno];
    const int cblksty = tc.style.cblksty;
    // SOP in the body
    if (csty & 2) {
        if (body.n - body.pos >= 6 && body.p[body.pos] == 0xff &&
            body.p[body.pos + 1] == 0x91)
            body.pos += 6;
    }
    HeaderSource& h = separate_headers ? hs : body;
    Bio bio(h.p + h.pos, h.n - h.pos);
    uint32_t present = bio.read(1);
    if (!present) {
        bio.inalign();
        size_t used = bio.numbytes();
        if (used > h.n - h.pos) fail();
        h.pos += used;
        if (csty & 4) {
            if (h.n - h.pos >= 2 && h.p[h.pos] == 0xff &&
                h.p[h.pos + 1] == 0x92)
                h.pos += 2;
        }
        return;
    }
    for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Prc& prc = band.prcs[precno];
        int ncb = prc.cw * prc.ch;
        for (int c = 0; c < ncb; ++c) {
            Cblk& cb = prc.cblks[c];
            uint32_t included;
            if (!cb.numsegs)
                included = prc.incl.decode(bio, c, layno + 1);
            else
                included = bio.read(1);
            if (!included) {
                cb.numnewpasses = 0;
                continue;
            }
            if (!cb.numsegs) {
                int i = 0;
                while (!prc.imsb.decode(bio, c, i)) ++i;
                cb.numbps = uint32_t(band.numbps + 1 - i);
                cb.numlenbits = 3;
            }
            // number of coding passes
            uint32_t np;
            if (!bio.read(1))
                np = 1;
            else if (!bio.read(1))
                np = 2;
            else if ((np = bio.read(2)) != 3)
                np = 3 + np;
            else if ((np = bio.read(5)) != 31)
                np = 6 + np;
            else
                np = 37 + bio.read(7);
            cb.numnewpasses = np;
            uint32_t incr = 0;
            while (bio.read(1)) ++incr;
            cb.numlenbits += incr;
            uint32_t segno = 0;
            if (!cb.numsegs) {
                init_seg(cb, 0, cblksty, true);
            } else {
                segno = cb.numsegs - 1;
                if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                    ++segno;
                    init_seg(cb, segno, cblksty, false);
                }
            }
            int32_t left = int32_t(np);
            do {
                Seg& sg = cb.segs[segno];
                sg.numnewpasses = uint32_t(
                    std::min<int64_t>(int64_t(sg.maxpasses) - sg.numpasses, left));
                uint32_t bits = cb.numlenbits + floorlog2(sg.numnewpasses);
                if (bits > 32) fail();
                sg.newlen = bio.read(int(bits));
                left -= int32_t(sg.numnewpasses);
                if (left > 0) {
                    ++segno;
                    init_seg(cb, segno, cblksty, false);
                }
            } while (left > 0);
        }
    }
    bio.inalign();
    size_t used = bio.numbytes();
    if (used > h.n - h.pos) fail();
    h.pos += used;
    if (csty & 4) {
        if (h.n - h.pos >= 2 && h.p[h.pos] == 0xff && h.p[h.pos + 1] == 0x92)
            h.pos += 2;
    }
    // packet body
    for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Prc& prc = band.prcs[precno];
        int ncb = prc.cw * prc.ch;
        for (int c = 0; c < ncb; ++c) {
            Cblk& cb = prc.cblks[c];
            if (!cb.numnewpasses) continue;
            uint32_t si;
            if (!cb.numsegs) {
                si = 0;
                ++cb.numsegs;
            } else {
                si = cb.numsegs - 1;
                if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                    ++si;
                    ++cb.numsegs;
                }
            }
            do {
                Seg& sg = cb.segs[si];
                if (sg.newlen > body.n - body.pos) fail();
                cb.chunks.push_back(Span{body.p + body.pos, sg.newlen});
                body.pos += sg.newlen;
                sg.len += sg.newlen;
                sg.numpasses += sg.numnewpasses;
                cb.numnewpasses -= sg.numnewpasses;
                if (cb.numnewpasses > 0) {
                    ++si;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
        }
    }
}

// -------------------------------------------------------- packet iterator
// opj_pi_next_* over one progression (a POC entry or the COD's order);
// `include` keeps a packet from being read twice across entries.
struct PacketIter {
    std::vector<TileComp>& tcs;
    const std::vector<CompSiz>& comps;
    int tx0, ty0, tx1, ty1;
    int numlayers;
    std::vector<uint8_t>& include;
    int step_l, step_r, step_c, step_p;

    template <class F>
    void run(const Poc& poc, F emit) {
        const int ncomp = int(tcs.size());
        const int compno1 = std::min(poc.compno1, ncomp);
        const int layno1 = std::min(poc.layno1, numlayers);
        auto take = [&](int l, int r, int c, int p) {
            size_t idx = size_t(l) * step_l + size_t(r) * step_r +
                         size_t(c) * step_c + size_t(p) * step_p;
            if (idx >= include.size()) fail();
            if (include[idx]) return;
            include[idx] = 1;
            emit(c, r, p, l);
        };
        if (poc.prg == 0 || poc.prg == 1) {  // LRCP, RLCP
            auto body = [&](int l, int r) {
                for (int c = poc.compno0; c < compno1; ++c) {
                    TileComp& tc = tcs[c];
                    if (r >= tc.numres) continue;
                    int np = tc.res[r].pw * tc.res[r].ph;
                    for (int p = 0; p < np; ++p) take(l, r, c, p);
                }
            };
            if (poc.prg == 0) {
                for (int l = 0; l < layno1; ++l)
                    for (int r = poc.resno0; r < poc.resno1; ++r) body(l, r);
            } else {
                for (int r = poc.resno0; r < poc.resno1; ++r)
                    for (int l = 0; l < layno1; ++l) body(l, r);
            }
            return;
        }
        // position-driven orders
        auto steps = [&](int c0, int c1, uint32_t& sdx, uint32_t& sdy) {
            sdx = sdy = 0;
            for (int c = c0; c < c1; ++c) {
                const TileComp& tc = tcs[c];
                for (int r = 0; r < tc.numres; ++r) {
                    uint32_t sh = uint32_t(tc.res[r].pdx + tc.numres - 1 - r);
                    if (sh < 32 &&
                        uint32_t(comps[c].dx) <= UINT32_MAX / (1u << sh)) {
                        uint32_t d = uint32_t(comps[c].dx) * (1u << sh);
                        sdx = sdx ? std::min(sdx, d) : d;
                    }
                    sh = uint32_t(tc.res[r].pdy + tc.numres - 1 - r);
                    if (sh < 32 &&
                        uint32_t(comps[c].dy) <= UINT32_MAX / (1u << sh)) {
                        uint32_t d = uint32_t(comps[c].dy) * (1u << sh);
                        sdy = sdy ? std::min(sdy, d) : d;
                    }
                }
            }
        };
        // the precinct of component c, resolution r at (x, y), or -1
        auto prec_at = [&](int c, int r, uint32_t x, uint32_t y) -> int {
            TileComp& tc = tcs[c];
            if (r >= tc.numres) return -1;
            Res& res = tc.res[r];
            uint32_t lev = uint32_t(tc.numres - 1 - r);
            uint64_t cdx = uint64_t(comps[c].dx) << lev;
            uint64_t cdy = uint64_t(comps[c].dy) << lev;
            if (cdx > INT_MAX || cdy > INT_MAX) return -1;
            uint32_t trx0 = uint32_t(ceildiv(tx0, int64_t(cdx)));
            uint32_t try0 = uint32_t(ceildiv(ty0, int64_t(cdy)));
            uint32_t trx1 = uint32_t(ceildiv(tx1, int64_t(cdx)));
            uint32_t try1 = uint32_t(ceildiv(ty1, int64_t(cdy)));
            uint32_t rpx = uint32_t(res.pdx) + lev, rpy = uint32_t(res.pdy) + lev;
            if (rpx >= 31 || rpy >= 31) return -1;
            if (!((uint64_t(y) % (uint64_t(comps[c].dy) << rpy) == 0) ||
                  (y == uint32_t(ty0) &&
                   ((uint64_t(try0) << lev) % (uint64_t(1) << rpy)))))
                return -1;
            if (!((uint64_t(x) % (uint64_t(comps[c].dx) << rpx) == 0) ||
                  (x == uint32_t(tx0) &&
                   ((uint64_t(trx0) << lev) % (uint64_t(1) << rpx)))))
                return -1;
            if (res.pw == 0 || res.ph == 0) return -1;
            if (trx0 == trx1 || try0 == try1) return -1;
            uint32_t prci = (uint32_t(ceildiv(x, int64_t(cdx))) >> res.pdx) -
                            (trx0 >> res.pdx);
            uint32_t prcj = (uint32_t(ceildiv(y, int64_t(cdy))) >> res.pdy) -
                            (try0 >> res.pdy);
            return int(prci + prcj * uint32_t(res.pw));
        };
        auto layers = [&](int c, int r, int p) {
            for (int l = 0; l < layno1; ++l) take(l, r, c, p);
        };
        if (poc.prg == 2) {  // RPCL
            uint32_t sdx, sdy;
            steps(0, ncomp, sdx, sdy);
            if (!sdx || !sdy) fail();
            for (int r = poc.resno0; r < poc.resno1; ++r)
                for (uint32_t y = uint32_t(ty0); y < uint32_t(ty1);
                     y += sdy - (y % sdy))
                    for (uint32_t x = uint32_t(tx0); x < uint32_t(tx1);
                         x += sdx - (x % sdx))
                        for (int c = poc.compno0; c < compno1; ++c) {
                            int p = prec_at(c, r, x, y);
                            if (p >= 0) layers(c, r, p);
                        }
        } else if (poc.prg == 3) {  // PCRL
            uint32_t sdx, sdy;
            steps(0, ncomp, sdx, sdy);
            if (!sdx || !sdy) fail();
            for (uint32_t y = uint32_t(ty0); y < uint32_t(ty1);
                 y += sdy - (y % sdy))
                for (uint32_t x = uint32_t(tx0); x < uint32_t(tx1);
                     x += sdx - (x % sdx))
                    for (int c = poc.compno0; c < compno1; ++c)
                        for (int r = poc.resno0;
                             r < std::min(poc.resno1, tcs[c].numres); ++r) {
                            int p = prec_at(c, r, x, y);
                            if (p >= 0) layers(c, r, p);
                        }
        } else {  // CPRL
            for (int c = poc.compno0; c < compno1; ++c) {
                uint32_t sdx, sdy;
                steps(c, c + 1, sdx, sdy);
                if (!sdx || !sdy) fail();
                for (uint32_t y = uint32_t(ty0); y < uint32_t(ty1);
                     y += sdy - (y % sdy))
                    for (uint32_t x = uint32_t(tx0); x < uint32_t(tx1);
                         x += sdx - (x % sdx))
                        for (int r = poc.resno0;
                             r < std::min(poc.resno1, tcs[c].numres); ++r) {
                            int p = prec_at(c, r, x, y);
                            if (p >= 0) layers(c, r, p);
                        }
            }
        }
    }
};

// ---------------------------------------------------------------- MQ coder
struct QeState {
    uint16_t qe;
    uint8_t nmps, nlps, sw;
};
const QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct Mqc {
    const uint8_t* bp;  // into `data`, which ends in 0xFF 0xFF
    uint32_t a = 0, c = 0;
    int ct = 0;
    uint8_t state[NUM_CTX];
    uint8_t mps[NUM_CTX];

    void reset_states() {
        std::memset(state, 0, sizeof state);
        std::memset(mps, 0, sizeof mps);
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                ++bp;
                c += uint32_t(*bp) << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += uint32_t(*bp) << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, uint32_t len) {  // p[len], p[len+1] = 0xFF
        bp = p;
        c = len == 0 ? (0xffu << 16) : (uint32_t(*bp) << 16);
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void init_raw(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    int decode(int cx) {
        const QeState& s = kQe[state[cx]];
        uint32_t qe = s.qe;
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            // LPS exchange
            if (a < qe) {
                a = qe;
                d = mps[cx];
                state[cx] = s.nmps;
            } else {
                a = qe;
                d = 1 - mps[cx];
                if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
                state[cx] = s.nlps;
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                // MPS exchange
                if (a < qe) {
                    d = 1 - mps[cx];
                    if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
                    state[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return int((c >> ct) & 1);
    }
};

// ---------------------------------------------------------------- tier 1
enum : uint8_t { F_SIG = 1, F_NEG = 2, F_PI = 4, F_MU = 8 };

struct T1 {
    int w = 0, h = 0, fs = 0;  // fs: flag row stride (w + 2)
    std::vector<int32_t> data;
    std::vector<uint8_t> flags;  // (h + 2) x (w + 2), a zero border
    Mqc mqc;
    int orient = 0;
    bool vsc = false;

    uint8_t& fl(int x, int y) { return flags[size_t(y + 1) * fs + x + 1]; }
    // significance of the neighbour (dx, dy) of (x, y), with the
    // vertically causal rule: the last row of a stripe does not see the
    // next stripe
    inline bool south_hidden(int y) const { return vsc && (y & 3) == 3; }

    int zc_ctx(int x, int y) {
        const uint8_t* up = &flags[size_t(y) * fs + x];
        const uint8_t* mid = up + fs;
        const uint8_t* dn = mid + fs;
        bool hide = south_hidden(y);
        int hh = (mid[0] & F_SIG) + (mid[2] & F_SIG);
        int vv = (up[1] & F_SIG) + (hide ? 0 : (dn[1] & F_SIG));
        int dd = (up[0] & F_SIG) + (up[2] & F_SIG) +
                 (hide ? 0 : (dn[0] & F_SIG) + (dn[2] & F_SIG));
        int n;
        if (orient == 3) {
            int hv = hh + vv;
            if (dd >= 3)
                n = 8;
            else if (dd == 2)
                n = hv >= 1 ? 7 : 6;
            else if (dd == 1)
                n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
            else
                n = hv >= 2 ? 2 : hv;
        } else {
            if (orient == 1) std::swap(hh, vv);
            if (hh == 0) {
                if (vv == 0)
                    n = dd == 0 ? 0 : dd == 1 ? 1 : 2;
                else
                    n = vv == 1 ? 3 : 4;
            } else if (hh == 1) {
                n = vv ? 7 : dd ? 6 : 5;
            } else {
                n = 8;
            }
        }
        return CTX_ZC + n;
    }
    bool any_neighbour(int x, int y) {
        const uint8_t* up = &flags[size_t(y) * fs + x];
        const uint8_t* mid = up + fs;
        const uint8_t* dn = mid + fs;
        int s = (up[0] | up[1] | up[2] | mid[0] | mid[2]) & F_SIG;
        if (!south_hidden(y)) s |= (dn[0] | dn[1] | dn[2]) & F_SIG;
        return s != 0;
    }
    // sign context and the bit it is XORed with
    int sc_ctx(int x, int y, int& xorbit) {
        auto contrib = [](uint8_t f) {
            return (f & F_SIG) ? ((f & F_NEG) ? -1 : 1) : 0;
        };
        const uint8_t* mid = &flags[size_t(y + 1) * fs + x];
        int hc = contrib(mid[0]) + contrib(mid[2]);
        int vc = contrib(mid[1 - fs]) +
                 (south_hidden(y) ? 0 : contrib(mid[1 + fs]));
        hc = std::max(-1, std::min(1, hc));
        vc = std::max(-1, std::min(1, vc));
        if (hc < 0) {
            hc = -hc;
            vc = -vc;
            xorbit = 1;
        } else if (hc == 0 && vc < 0) {
            vc = -vc;
            xorbit = 1;
        } else {
            xorbit = 0;
        }
        // (hc, vc) now (1, 1)->13, (1, 0)->12, (1, -1)->11, (0, 1)->10,
        // (0, 0)->9
        int n = hc == 1 ? (vc == 1 ? 4 : vc == 0 ? 3 : 2) : (vc == 1 ? 1 : 0);
        return CTX_SC + n;
    }
    void set_sig(int x, int y, int neg, int32_t v) {
        data[size_t(y) * w + x] = neg ? -v : v;
        fl(x, y) |= F_SIG | (neg ? F_NEG : 0);
    }
    void decode_sign(int x, int y, int32_t oneplushalf) {
        int xorbit;
        int ctx = sc_ctx(x, y, xorbit);
        int v = mqc.decode(ctx) ^ xorbit;
        set_sig(x, y, v, oneplushalf);
    }

    void sigpass(int bpno, bool raw) {
        int32_t one = int32_t(1) << bpno;
        int32_t oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint8_t& f = fl(x, y);
                    if (f & (F_SIG | F_PI)) continue;
                    if (!any_neighbour(x, y)) continue;
                    if (raw) {
                        if (mqc.raw()) {
                            int neg = mqc.raw();
                            set_sig(x, y, neg, oneplushalf);
                        }
                    } else if (mqc.decode(zc_ctx(x, y))) {
                        decode_sign(x, y, oneplushalf);
                    }
                    f |= F_PI;
                }
    }
    void refpass(int bpno, bool raw) {
        int32_t poshalf = (int32_t(1) << bpno) >> 1;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint8_t& f = fl(x, y);
                    if ((f & (F_SIG | F_PI)) != F_SIG) continue;
                    int v;
                    if (raw) {
                        v = mqc.raw();
                    } else {
                        int ctx = (f & F_MU) ? CTX_MAG + 2
                                  : any_neighbour(x, y) ? CTX_MAG + 1
                                                        : CTX_MAG;
                        v = mqc.decode(ctx);
                    }
                    int32_t& d = data[size_t(y) * w + x];
                    d += (v ^ (d < 0)) ? poshalf : -poshalf;
                    f |= F_MU;
                }
    }
    void clnpass(int bpno, bool segsym) {
        int32_t one = int32_t(1) << bpno;
        int32_t oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4) {
            for (int x = 0; x < w; ++x) {
                int y0 = k;
                if (k + 4 <= h) {
                    bool rl = true;
                    for (int y = k; y < k + 4 && rl; ++y)
                        if ((fl(x, y) & (F_SIG | F_PI)) || any_neighbour(x, y))
                            rl = false;
                    if (rl) {
                        if (!mqc.decode(CTX_AGG)) continue;
                        int r = mqc.decode(CTX_UNI);
                        r = (r << 1) | mqc.decode(CTX_UNI);
                        decode_sign(x, k + r, oneplushalf);
                        y0 = k + r + 1;
                    }
                }
                for (int y = y0; y < std::min(k + 4, h); ++y) {
                    uint8_t f = fl(x, y);
                    if (f & (F_SIG | F_PI)) continue;
                    if (mqc.decode(zc_ctx(x, y))) decode_sign(x, y, oneplushalf);
                }
            }
        }
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) fl(x, y) &= uint8_t(~F_PI);
        if (segsym) {
            for (int i = 0; i < 4; ++i) mqc.decode(CTX_UNI);
        }
    }

    // opj_t1_decode_cblk; false where OpenJPEG fails the code-block
    bool decode(const Cblk& cb, int orient_, int roishift, int cblksty,
                std::vector<uint8_t>& scratch) {
        w = cb.x1 - cb.x0;
        h = cb.y1 - cb.y0;
        fs = w + 2;
        data.assign(size_t(w) * h, 0);
        flags.assign(size_t(h + 2) * fs, 0);
        orient = orient_;
        vsc = (cblksty & 0x08) != 0;
        if (cb.numsegs == 0) return true;
        // as OpenJPEG: a zero-bit-plane count above the band's wraps the
        // unsigned count to a negative plane, and no pass is decoded
        int bpno_plus_one = int(uint32_t(roishift) + cb.numbps);
        if (bpno_plus_one >= 31) return false;
        int passtype = 2;
        mqc.reset_states();
        size_t total = 0;
        for (const Span& ch : cb.chunks) total += ch.n;
        scratch.resize(total + 2);
        size_t off = 0;
        for (const Span& ch : cb.chunks) {
            if (ch.n) std::memcpy(scratch.data() + off, ch.p, ch.n);
            off += ch.n;
        }
        std::vector<uint8_t> seg;
        size_t idx = 0;
        for (uint32_t s = 0; s < cb.numsegs; ++s) {
            const Seg& sg = cb.segs[s];
            bool raw = bpno_plus_one <= int(cb.numbps) - 4 && passtype < 2 &&
                       (cblksty & 0x01);
            seg.assign(scratch.begin() + idx, scratch.begin() + idx + sg.len);
            seg.push_back(0xff);
            seg.push_back(0xff);
            if (raw)
                mqc.init_raw(seg.data());
            else
                mqc.init(seg.data(), sg.len);
            idx += sg.len;
            for (uint32_t p = 0; p < sg.numpasses && bpno_plus_one >= 1; ++p) {
                // OpenJPEG's passes place bit-plane bpno_plus_one - 1 at
                // 1 << bpno_plus_one: one fractional bit, halved later
                int bpno = bpno_plus_one;
                switch (passtype) {
                case 0: sigpass(bpno, raw); break;
                case 1: refpass(bpno, raw); break;
                case 2: clnpass(bpno, (cblksty & 0x20) != 0); break;
                }
                if ((cblksty & 0x02) && !raw) mqc.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    --bpno_plus_one;
                }
            }
        }
        if (roishift) {
            int32_t thresh = int32_t(1) << roishift;
            for (int32_t& v : data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
        return true;
    }
};

// ---------------------------------------------------------------- wavelets
// The 5/3 inverse of one line `x` of sn low and dn high samples stored
// low first; `cas` = the line's origin is odd.
void idwt53_line(int32_t* x, int sn, int dn, int cas, std::vector<int32_t>& t) {
    int len = sn + dn;
    if (cas == 0) {
        if (len <= 1) return;
    } else {
        if (len == 1) {
            x[0] /= 2;
            return;
        }
    }
    t.resize(len);
    // interleave: lows at positions cas, cas+2, ...; highs at 1-cas, ...
    for (int i = 0; i < sn; ++i) t[cas + 2 * i] = x[i];
    for (int i = 0; i < dn; ++i) t[1 - cas + 2 * i] = x[sn + i];
    auto at = [&](int i) {  // symmetric extension
        if (i < 0) i = -i;
        if (i >= len) i = 2 * (len - 1) - i;
        return t[i];
    };
    // lows (even absolute positions): X(2n) -= floor((X(2n-1)+X(2n+1)+2)/4)
    for (int i = cas; i < len; i += 2) t[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
    for (int i = 1 - cas; i < len; i += 2) t[i] += (at(i - 1) + at(i + 1)) >> 1;
    std::memcpy(x, t.data(), sizeof(int32_t) * len);
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f;
const float kBeta = -0.052980118f;
const float kGamma = 0.882911075f;
const float kDelta = 0.443506852f;

// opj_v8dwt_decode on one line (scalar: the SSE form's per-lane arithmetic)
void idwt97_line(float* x, int sn, int dn, int cas, std::vector<float>& t) {
    int len = sn + dn;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
    } else {
        if (!(sn > 0 || dn > 1)) return;
    }
    t.resize(len);
    for (int i = 0; i < sn; ++i) t[cas + 2 * i] = x[i];
    for (int i = 0; i < dn; ++i) t[1 - cas + 2 * i] = x[sn + i];
    const int lo = cas, hi = 1 - cas;
    for (int i = lo; i < len; i += 2) t[i] = t[i] * kK;
    for (int i = hi; i < len; i += 2) t[i] = t[i] * kTwoInvK;
    auto lift = [&](int first, float c) {
        for (int i = first; i < len; i += 2) {
            bool has_l = i - 1 >= 0, has_r = i + 1 < len;
            if (has_l && has_r)
                t[i] = t[i] + (t[i - 1] + t[i + 1]) * c;
            else if (has_r)
                t[i] = t[i] + (t[i + 1] + t[i + 1]) * c;
            else if (has_l)
                t[i] = t[i] + (c + c) * t[i - 1];
        }
    };
    lift(lo, -kDelta);
    lift(hi, -kGamma);
    lift(lo, -kBeta);
    lift(hi, -kAlpha);
    std::memcpy(x, t.data(), sizeof(float) * len);
}

template <class T, class F>
void idwt2d(T* data, const TileComp& tc, F line) {
    int w = tc.x1 - tc.x0;
    std::vector<T> col, tmp;
    for (int r = 1; r < tc.numres; ++r) {
        const Res& prev = tc.res[r - 1];
        const Res& res = tc.res[r];
        int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
        int sn = prev.x1 - prev.x0, dn = rw - sn;
        int cas = res.x0 & 1;
        for (int j = 0; j < rh; ++j) line(data + size_t(j) * w, sn, dn, cas, tmp);
        int vsn = prev.y1 - prev.y0, vdn = rh - vsn;
        int vcas = res.y0 & 1;
        col.resize(rh);
        for (int i = 0; i < rw; ++i) {
            for (int j = 0; j < rh; ++j) col[j] = data[size_t(j) * w + i];
            line(col.data(), vsn, vdn, vcas, tmp);
            for (int j = 0; j < rh; ++j) data[size_t(j) * w + i] = col[j];
        }
    }
}

// ---------------------------------------------------------------- JP2 boxes
struct Jp2 {
    bool is_jp2 = false;
    uint32_t ihdr_w = 0, ihdr_h = 0, ihdr_nc = 0;
    int enumcs = -1;   // -1: no enumerated colour space (ICC, or no colr)
    bool colr_seen = false;
    // pclr
    bool pclr = false;
    int pclr_entries = 0, pclr_channels = 0;
    std::vector<int> pclr_size;
    std::vector<int> pclr_sign;
    std::vector<uint32_t> pclr_lut;  // entries x channels
    // cmap
    bool cmap = false;
    std::vector<int> cmap_cmp, cmap_mtyp, cmap_pcol;
    // cdef
    bool cdef = false;
    std::vector<int> cdef_cn, cdef_typ, cdef_asoc;
    const uint8_t* cs = nullptr;
    size_t cs_len = 0;
};

void read_jp2h(Jp2& j, const uint8_t* p, size_t n) {
    size_t pos = 0;
    bool first = true;
    while (pos + 8 <= n) {
        uint64_t lbox = be32(p + pos);
        uint32_t tbox = be32(p + pos + 4);
        size_t hdr = 8;
        if (lbox == 1) {
            if (pos + 16 > n) fail();
            lbox = (uint64_t(be32(p + pos + 8)) << 32) | be32(p + pos + 12);
            hdr = 16;
        } else if (lbox == 0) {
            lbox = n - pos;
        }
        if (lbox < hdr || lbox > n - pos) fail();
        const uint8_t* d = p + pos + hdr;
        size_t l = size_t(lbox - hdr);
        if (first && tbox != 0x69686472) fail();  // ihdr first
        first = false;
        if (tbox == 0x69686472) {  // ihdr
            if (l != 14) fail();
            j.ihdr_h = be32(d);
            j.ihdr_w = be32(d + 4);
            j.ihdr_nc = be16(d + 8);
            if (!j.ihdr_w || !j.ihdr_h || !j.ihdr_nc || j.ihdr_nc > 16384)
                fail();
        } else if (tbox == 0x636f6c72) {  // colr
            if (l < 3) fail();
            if (!j.colr_seen) {
                j.colr_seen = true;
                if (d[0] == 1) {
                    if (l < 7) fail();
                    j.enumcs = int(be32(d + 3));
                }
            }
        } else if (tbox == 0x70636c72) {  // pclr
            if (j.pclr) fail();
            if (l < 3) fail();
            int ne = int(be16(d)), nc = d[2];
            if (ne == 0 || ne > 1024 || nc == 0) fail();
            if (l < size_t(3 + nc)) fail();
            j.pclr = true;
            j.pclr_entries = ne;
            j.pclr_channels = nc;
            std::vector<int> bytes(nc);
            for (int i = 0; i < nc; ++i) {
                j.pclr_size.push_back((d[3 + i] & 0x7f) + 1);
                j.pclr_sign.push_back(d[3 + i] >> 7);
                bytes[i] = std::min(4, (j.pclr_size[i] + 7) >> 3);
            }
            size_t q = 3 + nc;
            j.pclr_lut.resize(size_t(ne) * nc);
            for (int e = 0; e < ne; ++e)
                for (int i = 0; i < nc; ++i) {
                    if (q + bytes[i] > l) fail();
                    uint32_t v = 0;
                    for (int b = 0; b < bytes[i]; ++b) v = (v << 8) | d[q++];
                    j.pclr_lut[size_t(e) * nc + i] = v;
                }
        } else if (tbox == 0x636d6170) {  // cmap
            if (!j.pclr || j.cmap) fail();
            int nc = j.pclr_channels;
            if (l < size_t(4 * nc)) fail();
            j.cmap = true;
            for (int i = 0; i < nc; ++i) {
                j.cmap_cmp.push_back(int(be16(d + 4 * i)));
                j.cmap_mtyp.push_back(d[4 * i + 2]);
                j.cmap_pcol.push_back(d[4 * i + 3]);
            }
        } else if (tbox == 0x63646566) {  // cdef
            if (j.cdef || l < 2) fail();
            int nd = int(be16(d));
            if (nd == 0 || l < size_t(2 + 6 * nd)) fail();
            j.cdef = true;
            for (int i = 0; i < nd; ++i) {
                j.cdef_cn.push_back(int(be16(d + 2 + 6 * i)));
                j.cdef_typ.push_back(int(be16(d + 4 + 6 * i)));
                j.cdef_asoc.push_back(int(be16(d + 6 + 6 * i)));
            }
        }
        pos += size_t(lbox);
    }
    if (first) fail();
}

void read_container(Jp2& j, const uint8_t* p, size_t n) {
    static const uint8_t sig[12] = {0, 0, 0, 0x0c, 0x6a, 0x50, 0x20, 0x20,
                                    0x0d, 0x0a, 0x87, 0x0a};
    if (n >= 12 && std::memcmp(p, sig, 12) == 0) {
        j.is_jp2 = true;
        size_t pos = 12;
        bool ftyp = false, jp2h = false;
        while (pos + 8 <= n) {
            uint64_t lbox = be32(p + pos);
            uint32_t tbox = be32(p + pos + 4);
            size_t hdr = 8;
            if (lbox == 1) {
                if (pos + 16 > n) fail();
                lbox = (uint64_t(be32(p + pos + 8)) << 32) | be32(p + pos + 12);
                hdr = 16;
            } else if (lbox == 0) {
                lbox = n - pos;
            }
            if (lbox < hdr) fail();
            size_t avail = n - pos;
            if (tbox == 0x6a703263) {  // jp2c: OpenJPEG reads to the end
                if (!ftyp || !jp2h) fail();
                j.cs = p + pos + hdr;
                j.cs_len = avail - hdr;
                return;
            }
            if (lbox > avail) fail();
            if (tbox == 0x66747970) {  // ftyp
                if (ftyp) fail();
                ftyp = true;
            } else if (tbox == 0x6a703268) {  // jp2h
                if (!ftyp || jp2h) fail();
                jp2h = true;
                read_jp2h(j, p + pos + hdr, size_t(lbox - hdr));
            } else if (!ftyp) {
                fail();
            }
            pos += size_t(lbox);
        }
        fail();
    }
    if (n >= 4 && be32(p) == 0xFF4FFF51) {
        j.cs = p;
        j.cs_len = n;
        return;
    }
    fail();
}

// ------------------------------------------------------- the whole decode
// What cv2 makes of the image: the output channels (B, G, R) as indices of
// the image components after pclr and cdef, or a YUV conversion.
struct Plan {
    int w = 0, h = 0;
    int shift = 0;
    bool yuv = false;
    int out[3];
    // image component m (after pclr / cdef) = codestream component
    // src[m], through palette column pal[m] (-1: direct)
    std::vector<int> src, pal;
};

// cv2's readHeader: signed components and a largest precision below 8
// (→ None); returns the largest precision
int header_checks(const Codestream& cs) {
    int maxprec = 0;
    for (const CompSiz& c : cs.comps) {
        if (c.sgnd) fail();
        maxprec = std::max(maxprec, c.prec);
    }
    if (maxprec < 8) fail();
    return maxprec;
}

Plan make_plan(const Codestream& cs, const Jp2& j) {
    Plan pl;
    int maxprec = header_checks(cs);
    pl.w = int(cs.Xsiz - cs.XOsiz);
    pl.h = int(cs.Ysiz - cs.YOsiz);
    pl.shift = maxprec - 8;
    int n = cs.numcomps;
    for (int m = 0; m < n; ++m) {
        pl.src.push_back(m);
        pl.pal.push_back(-1);
    }
    int colour = 0;  // 0 sRGB (also unknown, unspecified), 1 grey, 2 sYCC
    if (j.is_jp2) {
        // opj_jp2_check_color
        int nr = n;
        bool use_pclr = j.pclr && j.cmap;
        if (use_pclr) nr = j.pclr_channels;
        if (j.cdef) {
            int nd = int(j.cdef_cn.size());
            for (int i = 0; i < nd; ++i) {
                if (j.cdef_cn[i] >= nr) fail();
                if (j.cdef_asoc[i] == 65535) continue;
                if (j.cdef_asoc[i] > 0 && j.cdef_asoc[i] - 1 >= nr) fail();
            }
            for (int c = nr; c > 0; --c) {
                bool found = false;
                for (int i = 0; i < nd; ++i)
                    if (j.cdef_cn[i] == c - 1) found = true;
                if (!found) fail();
            }
        }
        std::vector<int> mtyp, pcol;
        if (use_pclr) {
            int nc = j.pclr_channels;
            mtyp = j.cmap_mtyp;
            pcol = j.cmap_pcol;
            std::vector<bool> used(nc, false);
            bool sane = true;
            for (int i = 0; i < nc; ++i)
                if (j.cmap_cmp[i] >= n) sane = false;
            for (int i = 0; i < nc; ++i) {
                if (mtyp[i] != 0 && mtyp[i] != 1)
                    sane = false;
                else if (pcol[i] >= nc)
                    sane = false;
                else if (used[pcol[i]] && mtyp[i] == 1)
                    sane = false;
                else if (mtyp[i] == 0 && pcol[i] != 0)
                    sane = false;
                else if (mtyp[i] == 1 && pcol[i] != i)
                    sane = false;
                else
                    used[pcol[i]] = true;
            }
            for (int i = 0; i < nc; ++i)
                if (!used[i] && mtyp[i] != 0) sane = false;
            if (sane && n == 1) {
                bool all = true;
                for (int i = 0; i < nc; ++i)
                    if (!used[i]) all = false;
                if (!all)
                    for (int i = 0; i < nc; ++i) {
                        mtyp[i] = 1;
                        pcol[i] = i;
                    }
            }
            if (!sane) fail();
        }
        if (j.enumcs == 16)
            colour = 0;
        else if (j.enumcs == 17)
            colour = 1;
        else if (j.enumcs == 18)
            colour = 2;
        else if (j.enumcs == 24 || j.enumcs == 12)
            fail();  // e-sYCC, CMYK: cv2 has no conversion
        if (use_pclr) {
            int nc = j.pclr_channels;
            std::vector<int> src(nc), pal(nc);
            for (int i = 0; i < nc; ++i) {
                src[i] = j.cmap_cmp[i];
                pal[i] = mtyp[i] == 0 ? -1 : pcol[i];
            }
            pl.src = src;
            pl.pal = pal;
        }
        if (j.cdef) {
            std::vector<int> cn = j.cdef_cn;
            int nd = int(cn.size());
            int numc = int(pl.src.size());
            for (int i = 0; i < nd; ++i) {
                int asoc = j.cdef_asoc[i], c = cn[i];
                if (c >= numc) continue;
                if (asoc == 0 || asoc == 65535) continue;
                int acn = asoc - 1;
                if (acn >= numc) continue;
                if (c != acn && j.cdef_typ[i] == 0) {
                    std::swap(pl.src[c], pl.src[acn]);
                    std::swap(pl.pal[c], pl.pal[acn]);
                    for (int k = i + 1; k < nd; ++k) {
                        if (cn[k] == c)
                            cn[k] = acn;
                        else if (cn[k] == acn)
                            cn[k] = c;
                    }
                }
            }
        }
    }
    // cv2's readData: every component at the image's size and origin 0
    if (cs.XOsiz != 0 || cs.YOsiz != 0) fail();
    for (int s : pl.src) {
        const CompSiz& c = cs.comps[s];
        if (c.dx != 1 || c.dy != 1) fail();
    }
    int nimg = int(pl.src.size());
    if (colour == 0) {
        if (nimg < 3) fail();
        pl.out[0] = 2;
        pl.out[1] = 1;
        pl.out[2] = 0;
    } else if (colour == 1) {
        pl.out[0] = pl.out[1] = pl.out[2] = 0;
    } else {
        if (nimg < 3) fail();
        pl.yuv = true;
        pl.out[0] = 0;
        pl.out[1] = 1;
        pl.out[2] = 2;
    }
    return pl;
}

// cv2's 8-bit YUV -> BGR (YCrCb2RGB_i, BT.601 YUV coefficients)
inline uint8_t sat8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
void yuv_to_bgr(uint8_t* px) {
    int y = px[0], u = px[1] - 128, v = px[2] - 128;
    const int sh = 14, half = 1 << 13;
    int b = y + ((u * 33292 + half) >> sh);
    int g = y + ((u * -6472 + v * -9519 + half) >> sh);
    int r = y + ((v * 18678 + half) >> sh);
    px[0] = sat8(b);
    px[1] = sat8(g);
    px[2] = sat8(r);
}

// One pixel of codestream component values → BGR: the image components
// through pclr / cdef, cv2's shift and cast, its YUV conversion.
void to_pixel(const Plan& pl, const Jp2& j, const int32_t* v, uint8_t* px) {
    const int npal = j.pclr_channels;
    const int top = j.pclr_entries - 1;
    for (int k = 0; k < 3; ++k) {
        int m = pl.out[k];
        int32_t s = v[pl.src[m]];
        int col = pl.pal[m];
        if (col >= 0) {
            int e = s < 0 ? 0 : s > top ? top : s;
            s = int32_t(j.pclr_lut[size_t(e) * npal + col]);
        }
        px[k] = uint8_t(s >> pl.shift);
    }
    if (pl.yuv) yuv_to_bgr(px);
}

void decode_tile(const Codestream& cs, int tileno, const Jp2& j,
                 const Plan& pl, uint8_t* out) {
    const TileHeader& th = cs.tiles[tileno];
    int p = tileno % int(cs.tw), q = tileno / int(cs.tw);
    int tx0 = int(std::max<int64_t>(int64_t(cs.XTOsiz) + int64_t(p) * cs.XTsiz, cs.XOsiz));
    int ty0 = int(std::max<int64_t>(int64_t(cs.YTOsiz) + int64_t(q) * cs.YTsiz, cs.YOsiz));
    int tx1 = int(std::min<int64_t>(int64_t(cs.XTOsiz) + int64_t(p + 1) * cs.XTsiz, cs.Xsiz));
    int ty1 = int(std::min<int64_t>(int64_t(cs.YTOsiz) + int64_t(q + 1) * cs.YTsiz, cs.Ysiz));
    const Params& pm = cs.params(tileno);
    const int nc = cs.numcomps;
    std::vector<TileComp> tcs(nc);
    int maxres = 0;
    for (int c = 0; c < nc; ++c) {
        TileComp& tc = tcs[c];
        tc.style = pm.style[c];
        tc.quant = pm.quant[c];
        tc.roishift = pm.roishift[c];
        init_tilecomp(tc, cs.comps[c], tx0, ty0, tx1, ty1);
        maxres = std::max(maxres, tc.numres);
    }
    // packets
    int maxprec = 0;
    for (auto& tc : tcs)
        for (auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
    int numlayers = pm.numlayers;
    size_t step_p = 1, step_c = size_t(maxprec) * step_p,
           step_r = size_t(nc) * step_c, step_l = size_t(maxres) * step_r;
    size_t nincl = size_t(numlayers + 1) * step_l;
    if (nincl > (size_t(1) << 31)) fail();
    std::vector<uint8_t> include(nincl, 0);
    std::vector<uint8_t> body_buf, hdr_buf;
    for (const Span& sp : th.parts) body_buf.insert(body_buf.end(), sp.p, sp.p + sp.n);
    bool separate = false;
    if (cs.ppm) {
        separate = true;
        for (auto& ch : th.ppm)
            hdr_buf.insert(hdr_buf.end(), cs.ppm_all.begin() + ch.first,
                           cs.ppm_all.begin() + ch.first + ch.second);
    } else if (!th.ppt.empty()) {
        separate = true;
        auto segs = th.ppt;
        std::stable_sort(segs.begin(), segs.end(),
                         [](const std::pair<int, Span>& a,
                            const std::pair<int, Span>& b) {
                             return a.first < b.first;
                         });
        for (auto& sg : segs)
            hdr_buf.insert(hdr_buf.end(), sg.second.p, sg.second.p + sg.second.n);
    }
    HeaderSource body{body_buf.data(), body_buf.size(), 0};
    HeaderSource hs{hdr_buf.data(), hdr_buf.size(), 0};
    PacketIter it{tcs, cs.comps, tx0, ty0, tx1, ty1, numlayers, include,
                  int(step_l), int(step_r), int(step_c), int(step_p)};
    auto emit = [&](int c, int r, int pr, int l) {
        read_packet(tcs, c, r, pr, l, pm.csty, hs, body, separate);
    };
    if (pm.poc.empty()) {
        Poc all{0, 0, numlayers, maxres, nc, pm.prg};
        it.run(all, emit);
    } else {
        for (const Poc& pc : pm.poc) it.run(pc, emit);
    }
    // tier 1, dequantisation, wavelets, per component
    std::vector<std::vector<int32_t>> idata(nc);
    std::vector<std::vector<float>> fdata(nc);
    T1 t1;
    std::vector<uint8_t> scratch;
    for (int c = 0; c < nc; ++c) {
        TileComp& tc = tcs[c];
        int w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
        bool rev = tc.style.qmfbid == 1;
        if (rev)
            idata[c].assign(size_t(w) * h, 0);
        else
            fdata[c].assign(size_t(w) * h, 0.0f);
        for (int r = 0; r < tc.numres; ++r) {
            Res& res = tc.res[r];
            for (int b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                for (Prc& prc : band.prcs)
                    for (Cblk& cb : prc.cblks) {
                        if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
                        if (!t1.decode(cb, band.bandno, tc.roishift,
                                       tc.style.cblksty, scratch))
                            fail();
                        int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                        if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                        int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
                        if (rev) {
                            for (int jy = 0; jy < ch; ++jy)
                                for (int ix = 0; ix < cw; ++ix)
                                    idata[c][size_t(y + jy) * w + x + ix] =
                                        t1.data[size_t(jy) * cw + ix] / 2;
                        } else {
                            const float step = 0.5f * band.stepsize;
                            for (int jy = 0; jy < ch; ++jy)
                                for (int ix = 0; ix < cw; ++ix)
                                    fdata[c][size_t(y + jy) * w + x + ix] =
                                        float(t1.data[size_t(jy) * cw + ix]) * step;
                        }
                    }
            }
        }
        for (auto& r : tc.res)
            for (auto& b : r.bands) b.prcs.clear();
        if (rev)
            idwt2d(idata[c].data(), tc, idwt53_line);
        else
            idwt2d(fdata[c].data(), tc, idwt97_line);
    }
    // multiple component transform
    if (pm.mct == 1 && nc >= 3) {
        for (int c = 1; c < 3; ++c)
            if (tcs[c].x1 - tcs[c].x0 != tcs[0].x1 - tcs[0].x0 ||
                tcs[c].y1 - tcs[c].y0 != tcs[0].y1 - tcs[0].y0)
                fail();
        size_t n = size_t(tcs[0].x1 - tcs[0].x0) * (tcs[0].y1 - tcs[0].y0);
        if (tcs[0].style.qmfbid == 1) {
            for (int c = 0; c < 3; ++c)
                if (tcs[c].style.qmfbid != 1) fail();
            int32_t *c0 = idata[0].data(), *c1 = idata[1].data(), *c2 = idata[2].data();
            for (size_t i = 0; i < n; ++i) {
                int32_t y = c0[i], u = c1[i], v = c2[i];
                int32_t g = y - ((u + v) >> 2);
                int32_t r = v + g;
                int32_t b = u + g;
                c0[i] = r;
                c1[i] = g;
                c2[i] = b;
            }
        } else {
            for (int c = 0; c < 3; ++c)
                if (tcs[c].style.qmfbid != 0) fail();
            float *c0 = fdata[0].data(), *c1 = fdata[1].data(), *c2 = fdata[2].data();
            for (size_t i = 0; i < n; ++i) {
                float y = c0[i], u = c1[i], v = c2[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * 0.71414f);
                float b = y + (u * 1.772f);
                c0[i] = r;
                c1[i] = g;
                c2[i] = b;
            }
        }
    }
    // DC level shift and clip, into integers
    for (int c = 0; c < nc; ++c) {
        const CompSiz& comp = cs.comps[c];
        int32_t lo, hi;
        int64_t shift;
        if (comp.sgnd) {
            lo = -(int32_t(1) << (comp.prec - 1));
            hi = (int32_t(1) << (comp.prec - 1)) - 1;
            shift = 0;
        } else {
            lo = 0;
            hi = int32_t((uint32_t(1) << comp.prec) - 1);
            shift = int64_t(1) << (comp.prec - 1);
        }
        if (tcs[c].style.qmfbid == 1) {
            for (int32_t& v : idata[c])
                v = int32_t(std::max<int64_t>(lo, std::min<int64_t>(hi, int64_t(v) + shift)));
        } else {
            idata[c].resize(fdata[c].size());
            for (size_t i = 0; i < fdata[c].size(); ++i) {
                float f = fdata[c][i];
                int32_t v;
                if (f > float(INT_MAX))
                    v = hi;
                else if (f < float(INT_MIN))
                    v = lo;
                else
                    v = int32_t(std::max<int64_t>(
                        lo, std::min<int64_t>(hi, int64_t(lrintf(f)) + shift)));
                idata[c][i] = v;
            }
            std::vector<float>().swap(fdata[c]);
        }
    }
    // into the output
    int tw = tx1 - tx0, th_ = ty1 - ty0;
    std::vector<int32_t> v(nc);
    for (int y = 0; y < th_; ++y) {
        uint8_t* row = out + (size_t(ty0 + y) * pl.w + tx0) * 3;
        for (int x = 0; x < tw; ++x) {
            size_t i = size_t(y) * tw + x;
            for (int c = 0; c < nc; ++c) v[c] = idata[c][i];
            to_pixel(pl, j, v.data(), row + size_t(x) * 3);
        }
    }
}

struct Parsed {
    Jp2 jp2;
    Codestream cs;
};

// OpenJPEG holds the codestream's image size to the JP2 ihdr box's
void check_ihdr(const Codestream& cs, const Jp2& j) {
    if (!j.is_jp2) return;
    if (cs.Xsiz - cs.XOsiz != j.ihdr_w || cs.Ysiz - cs.YOsiz != j.ihdr_h)
        fail();
}

void parse(Parsed& ps, const uint8_t* buf, size_t n) {
    read_container(ps.jp2, buf, n);
    read_codestream(ps.cs, ps.jp2.cs, ps.jp2.cs_len, nullptr);
    check_ihdr(ps.cs, ps.jp2);
}

}  // namespace

extern "C" {

// Image size of a JPEG 2000 file cv2 reads the header of: 0, or 1 where
// cv2 gives None before its size check (not JPEG 2000, a header OpenJPEG
// refuses, signed components, precisions cv2 refuses).
int ocr_jp2_info(const uint8_t* buf, long long n, int* w, int* h) try {
    Parsed ps;
    parse(ps, buf, size_t(n));
    header_checks(ps.cs);
    *w = int(ps.cs.Xsiz - ps.cs.XOsiz);
    *h = int(ps.cs.Ysiz - ps.cs.YOsiz);
    return 0;
} catch (...) {
    return 1;
}

// Decodes into out (h, w, 3) BGR: 0, or 1 where cv2 gives None.
int ocr_jp2_decode(const uint8_t* buf, long long n, int h, int w,
                   uint8_t* out) try {
    Parsed ps;
    parse(ps, buf, size_t(n));
    Plan pl = make_plan(ps.cs, ps.jp2);
    if (pl.w != w || pl.h != h) return 1;
    {  // tiles that are not in the stream stay 0
        std::vector<int32_t> zero(size_t(ps.cs.numcomps), 0);
        uint8_t px[3];
        to_pixel(pl, ps.jp2, zero.data(), px);
        for (size_t i = 0; i < size_t(w) * h; ++i) std::memcpy(out + 3 * i, px, 3);
    }
    Codestream full;  // the main header again, then the tile-parts
    read_codestream(full, ps.jp2.cs, ps.jp2.cs_len, [&](int t) {
        decode_tile(full, t, ps.jp2, pl, out);
    });
    return 0;
} catch (...) {
    return 1;
}

}  // extern "C"
