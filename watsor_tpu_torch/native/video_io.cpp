// Copy of watsor_tpu/native/video_io.cpp: paths adapted.
// watsor-tpu native video I/O runtime.
//
// The reference shells out to the ffmpeg CLI per camera and pipes raw RGB24
// over stdout/stdin (upstream watsor/stream/ffmpeg.py) — one
// subprocess + pipe copy per stream. Here the demux/decode/scale loop runs
// in-process against the FFmpeg libraries and writes decoded pixels
// DIRECTLY into the Python-owned frame arena (the pointer passed to
// wt_decoder_read is a numpy slice of the shared ring), eliminating the
// subprocess, the pipe, and the extra copy. The decoder also emits a
// second, detect-resolution plane in the same pass (swscale), so the host
// never resizes again and the TPU batch ships as-is.
//
// C ABI for ctypes; every handle is used from a single Python thread (the
// decoder/encoder task), which ctypes calls with the GIL released.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/hwcontext.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/time.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

namespace {

void set_err(char* errbuf, int errbuf_len, const std::string& msg) {
    if (errbuf && errbuf_len > 0) {
        std::snprintf(errbuf, errbuf_len, "%s", msg.c_str());
    }
}

// ---------------------------------------------------------------------------
// libav log capture. The reference pumps every ffmpeg stderr line into its
// central logger (upstream watsor/stream/ffmpeg.py:211-224) — camera
// negotiation errors are the #1 operator debugging signal in an NVR. Here
// av_log is redirected into a bounded ring that Python drains into the
// logging system (watsor_tpu.io.native installs a pump thread).
// ---------------------------------------------------------------------------

struct LogEntry {
    int level;
    std::string msg;
};

std::mutex g_log_mutex;
std::deque<LogEntry> g_log_ring;
constexpr size_t kLogRingCap = 512;

void wt_log_callback(void* avcl, int level, const char* fmt, va_list vl) {
    if (level > AV_LOG_INFO) return;  // VERBOSE/DEBUG/TRACE: never buffered
    char line[1024];
    // av_log callbacks run concurrently from decoder/encoder worker
    // threads; the whole format+push runs under the ring mutex because
    // av_log_format_line's continuation state (print_prefix) is shared.
    static int print_prefix = 1;
    std::lock_guard<std::mutex> lock(g_log_mutex);
    // av_log_format_line prefixes "[h264 @ 0x...]"-style context, the same
    // prefix ffmpeg prints on stderr, so operators see familiar messages
    av_log_format_line(avcl, level, fmt, vl, line, sizeof(line),
                       &print_prefix);
    size_t len = std::strlen(line);
    while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r')) {
        line[--len] = '\0';
    }
    if (len == 0) return;
    if (g_log_ring.size() >= kLogRingCap) g_log_ring.pop_front();
    g_log_ring.push_back({level, std::string(line, len)});
}

std::string av_errstr(int err) {
    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
    av_strerror(err, buf, sizeof(buf));
    return std::string(buf);
}

// "key=value,key=value" -> AVDictionary
AVDictionary* parse_options(const char* options) {
    AVDictionary* dict = nullptr;
    if (options && *options) {
        av_dict_parse_string(&dict, options, "=", ",", 0);
    }
    return dict;
}

}  // namespace

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct WtDecoder {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwsContext* sws_full = nullptr;
    SwsContext* sws_detect = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    AVFrame* sw_frame = nullptr;   // hwaccel download target
    AVBufferRef* hw_device = nullptr;
    int stream_index = -1;
    int out_w = 0, out_h = 0;
    int detect_w = 0, detect_h = 0;
    bool draining = false;
    bool realtime = false;       // pace file playback by pts (ffmpeg -re)
    int64_t start_wall_us = -1;  // wall clock at first frame
    double first_pts = -1.0;
    double filter_fps = 0.0;     // ffmpeg `-vf fps=N`: pts-spaced frame drop
    double next_due_pts = -1.0;
};

extern "C" WtDecoder* wt_decoder_open(const char* url, int out_w, int out_h,
                                      int detect_w, int detect_h,
                                      const char* options, int realtime,
                                      const char* input_format,
                                      const char* hwaccel,
                                      const char* hwaccel_device,
                                      double filter_fps,
                                      char* errbuf, int errbuf_len) {
    avformat_network_init();
    av_log_set_callback(wt_log_callback);
    WtDecoder* d = new WtDecoder();
    d->out_w = out_w;
    d->out_h = out_h;
    d->detect_w = detect_w;
    d->detect_h = detect_h;
    d->realtime = realtime != 0;
    d->filter_fps = filter_fps > 0 ? filter_fps : 0.0;

    // honor `ffmpeg -f <fmt>` input forcing (v4l2 devices, mjpeg streams)
    const AVInputFormat* ifmt = nullptr;
    if (input_format && *input_format) {
        ifmt = av_find_input_format(input_format);
        if (!ifmt) {
            set_err(errbuf, errbuf_len,
                    std::string("unknown input format: ") + input_format);
            delete d;
            return nullptr;
        }
    }

    AVDictionary* dict = parse_options(options);
    int err = avformat_open_input(&d->fmt, url, ifmt, &dict);
    av_dict_free(&dict);
    if (err < 0) {
        set_err(errbuf, errbuf_len, "open_input: " + av_errstr(err));
        delete d;
        return nullptr;
    }
    if ((err = avformat_find_stream_info(d->fmt, nullptr)) < 0) {
        set_err(errbuf, errbuf_len, "find_stream_info: " + av_errstr(err));
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    const AVCodec* decoder = nullptr;
    d->stream_index = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                          &decoder, 0);
    if (d->stream_index < 0 || !decoder) {
        set_err(errbuf, errbuf_len, "no video stream");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    AVStream* stream = d->fmt->streams[d->stream_index];
    d->codec = avcodec_alloc_context3(decoder);
    avcodec_parameters_to_context(d->codec, stream->codecpar);
    d->codec->thread_count = 0;  // auto
    // `ffmpeg -hwaccel <method> [-hwaccel_device <dev>]`: create the named
    // hw device and hand it to the decoder. Like the ffmpeg CLI's default
    // (non-strict) behavior, failure to set the device up falls back to
    // software decoding with a warning rather than aborting the stream.
    if (hwaccel && *hwaccel) {
        AVHWDeviceType hw_type = av_hwdevice_find_type_by_name(hwaccel);
        if (hw_type == AV_HWDEVICE_TYPE_NONE) {
            av_log(nullptr, AV_LOG_WARNING,
                   "hwaccel '%s' is not known to this libav build; "
                   "decoding in software\n", hwaccel);
        } else {
            int hw_err = av_hwdevice_ctx_create(
                &d->hw_device, hw_type,
                (hwaccel_device && *hwaccel_device) ? hwaccel_device
                                                    : nullptr,
                nullptr, 0);
            if (hw_err < 0) {
                av_log(nullptr, AV_LOG_WARNING,
                       "hwaccel '%s' device setup failed (%s); decoding in "
                       "software\n", hwaccel, av_errstr(hw_err).c_str());
            } else {
                d->codec->hw_device_ctx = av_buffer_ref(d->hw_device);
            }
        }
    }
    // the same option string feeds the codec too: codec-level AVOptions the
    // demuxer didn't consume (flags=low_delay, ...) apply here; unknown
    // leftovers are ignored rather than fatal (ffmpeg CLI behavior)
    AVDictionary* codec_dict = parse_options(options);
    err = avcodec_open2(d->codec, decoder, &codec_dict);
    av_dict_free(&codec_dict);
    if (err < 0) {
        set_err(errbuf, errbuf_len, "codec open: " + av_errstr(err));
        avcodec_free_context(&d->codec);
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->pkt = av_packet_alloc();
    d->frame = av_frame_alloc();
    return d;
}

extern "C" int wt_decoder_src_width(WtDecoder* d) { return d->codec->width; }
extern "C" int wt_decoder_src_height(WtDecoder* d) { return d->codec->height; }

extern "C" double wt_decoder_fps(WtDecoder* d) {
    AVStream* stream = d->fmt->streams[d->stream_index];
    AVRational r = stream->avg_frame_rate;
    if (r.num == 0 || r.den == 0) r = stream->r_frame_rate;
    return (r.num && r.den) ? av_q2d(r) : 0.0;
}

static void wt_scale_out(WtDecoder* d, uint8_t* full_rgb, uint8_t* detect_rgb) {
    if (full_rgb && d->out_w > 0) {
        d->sws_full = sws_getCachedContext(
            d->sws_full, d->frame->width, d->frame->height,
            (AVPixelFormat)d->frame->format, d->out_w, d->out_h,
            AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
        uint8_t* dst[4] = {full_rgb, nullptr, nullptr, nullptr};
        int dst_stride[4] = {d->out_w * 3, 0, 0, 0};
        sws_scale(d->sws_full, d->frame->data, d->frame->linesize, 0,
                  d->frame->height, dst, dst_stride);
    }
    if (detect_rgb && d->detect_w > 0) {
        d->sws_detect = sws_getCachedContext(
            d->sws_detect, d->frame->width, d->frame->height,
            (AVPixelFormat)d->frame->format, d->detect_w, d->detect_h,
            AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
        uint8_t* dst[4] = {detect_rgb, nullptr, nullptr, nullptr};
        int dst_stride[4] = {d->detect_w * 3, 0, 0, 0};
        sws_scale(d->sws_detect, d->frame->data, d->frame->linesize, 0,
                  d->frame->height, dst, dst_stride);
    }
}

// Returns 0 on frame produced, 1 on EOF, negative AVERROR on failure.
extern "C" int wt_decoder_read(WtDecoder* d, uint8_t* full_rgb,
                               uint8_t* detect_rgb, double* pts_seconds) {
    AVStream* stream = d->fmt->streams[d->stream_index];
    while (true) {
        int err = avcodec_receive_frame(d->codec, d->frame);
        if (err == 0) {
            double pts = 0.0;
            if (d->frame->best_effort_timestamp != AV_NOPTS_VALUE) {
                pts = d->frame->best_effort_timestamp * av_q2d(stream->time_base);
            }
            // ffmpeg `-vf fps=N` drop semantics: keep frames spaced by
            // 1/N in presentation time, re-anchoring after gaps. Streams
            // without usable timestamps (raw elementary streams, some
            // MJPEG cameras) pass through undropped — pts re-reads as 0
            // there, and dropping on it would discard every frame after
            // the first, wedging the read loop forever on live sources.
            if (d->filter_fps > 0 &&
                d->frame->best_effort_timestamp != AV_NOPTS_VALUE) {
                if (d->next_due_pts >= 0 && pts + 1e-6 < d->next_due_pts) {
                    av_frame_unref(d->frame);
                    continue;  // dropped before any scaling work
                }
                double step = 1.0 / d->filter_fps;
                d->next_due_pts = (d->next_due_pts < 0 ? pts : d->next_due_pts)
                                  + step;
                if (pts > d->next_due_pts) d->next_due_pts = pts + step;
            }
            if (d->frame->hw_frames_ctx) {
                // hwaccel decode: download the surface to system memory
                if (!d->sw_frame) d->sw_frame = av_frame_alloc();
                int hw_err = av_hwframe_transfer_data(d->sw_frame, d->frame, 0);
                if (hw_err < 0) {
                    av_frame_unref(d->frame);
                    return hw_err;
                }
                d->sw_frame->best_effort_timestamp =
                    d->frame->best_effort_timestamp;
                av_frame_unref(d->frame);
                av_frame_move_ref(d->frame, d->sw_frame);
            }
            if (d->realtime) {
                // pace playback to presentation time (the analog of -re)
                if (d->start_wall_us < 0) {
                    d->start_wall_us = av_gettime_relative();
                    d->first_pts = pts;
                } else {
                    int64_t target = d->start_wall_us +
                        (int64_t)((pts - d->first_pts) * 1e6);
                    int64_t now = av_gettime_relative();
                    if (target > now && target - now < 10 * 1000 * 1000) {
                        av_usleep((unsigned)(target - now));
                    }
                }
            }
            wt_scale_out(d, full_rgb, detect_rgb);
            if (pts_seconds) *pts_seconds = pts;
            av_frame_unref(d->frame);
            return 0;
        }
        if (err == AVERROR_EOF) return 1;
        if (err != AVERROR(EAGAIN)) return err;
        if (d->draining) continue;

        // feed more input
        err = av_read_frame(d->fmt, d->pkt);
        if (err == AVERROR_EOF) {
            d->draining = true;
            avcodec_send_packet(d->codec, nullptr);
            continue;
        }
        if (err < 0) return err;
        if (d->pkt->stream_index == d->stream_index) {
            err = avcodec_send_packet(d->codec, d->pkt);
            if (err < 0 && err != AVERROR(EAGAIN)) {
                av_packet_unref(d->pkt);
                return err;
            }
        }
        av_packet_unref(d->pkt);
    }
}

extern "C" void wt_decoder_close(WtDecoder* d) {
    if (!d) return;
    if (d->sws_full) sws_freeContext(d->sws_full);
    if (d->sws_detect) sws_freeContext(d->sws_detect);
    av_frame_free(&d->frame);
    av_frame_free(&d->sw_frame);
    av_packet_free(&d->pkt);
    avcodec_free_context(&d->codec);
    av_buffer_unref(&d->hw_device);
    avformat_close_input(&d->fmt);
    delete d;
}

// ---------------------------------------------------------------------------
// Encoder (file recording or in-memory MPEG-TS broadcast)
// ---------------------------------------------------------------------------

struct WtEncoder {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    AVStream* stream = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    int w = 0, h = 0;
    int64_t next_pts = 0;
    bool header_written = false;
    // ffmpeg vsync emulation: `-r <in> -vsync drop` before -i paces the
    // raw input by dropping, `-r <out> -vsync cfr` after -i duplicates
    // frames to a constant output rate (the README "fluent video" trick,
    // upstream watsor/README.md:215-243)
    double input_fps = 0.0;       // drop input frames above this rate
    int64_t last_accept_us = -1;
    bool cfr = false;             // constant output rate by wall clock
    double out_fps = 30.0;
    int64_t cfr_start_us = -1;
    int64_t last_pts = -1;
    bool have_frame = false;      // e->frame holds a previous picture
    // in-memory sink for MPEG-TS broadcast (dest == "mem:")
    bool mem_sink = false;
    std::mutex mem_mutex;
    std::vector<uint8_t> mem_buf;
    AVIOContext* avio = nullptr;
    uint8_t* avio_buf = nullptr;
};

static int wt_mem_write(void* opaque, uint8_t* buf, int buf_size) {
    WtEncoder* e = static_cast<WtEncoder*>(opaque);
    std::lock_guard<std::mutex> lock(e->mem_mutex);
    e->mem_buf.insert(e->mem_buf.end(), buf, buf + buf_size);
    // bound the buffer: drop oldest data if nobody is reading (~8 MB cap)
    const size_t cap = 8 * 1024 * 1024;
    if (e->mem_buf.size() > cap) {
        e->mem_buf.erase(e->mem_buf.begin(),
                         e->mem_buf.begin() + (e->mem_buf.size() - cap));
    }
    return buf_size;
}

extern "C" WtEncoder* wt_encoder_open(const char* dest, const char* format,
                                      const char* codec_name, int w, int h,
                                      double fps, int64_t bit_rate,
                                      const char* options,
                                      double input_fps, int cfr,
                                      char* errbuf, int errbuf_len) {
    av_log_set_callback(wt_log_callback);
    WtEncoder* e = new WtEncoder();
    e->w = w;
    e->h = h;
    e->input_fps = input_fps > 0 ? input_fps : 0.0;
    e->cfr = cfr != 0;
    e->out_fps = fps > 0 ? fps : 30.0;
    e->mem_sink = dest && std::strncmp(dest, "mem:", 4) == 0;

    int err = avformat_alloc_output_context2(
        &e->fmt, nullptr, format && *format ? format : nullptr,
        e->mem_sink ? nullptr : dest);
    if (err < 0 || !e->fmt) {
        set_err(errbuf, errbuf_len, "alloc_output: " + av_errstr(err));
        delete e;
        return nullptr;
    }

    const AVCodec* codec = nullptr;
    if (codec_name && *codec_name) codec = avcodec_find_encoder_by_name(codec_name);
    if (!codec) codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_MPEG2VIDEO);
    if (!codec) {
        set_err(errbuf, errbuf_len, "no H.264/MPEG2 encoder available");
        avformat_free_context(e->fmt);
        delete e;
        return nullptr;
    }

    e->codec = avcodec_alloc_context3(codec);
    e->codec->width = w;
    e->codec->height = h;
    e->codec->pix_fmt = AV_PIX_FMT_YUV420P;
    AVRational fr = av_d2q(fps > 0 ? fps : 30.0, 1000000);
    e->codec->time_base = av_inv_q(fr);
    e->codec->framerate = fr;
    e->codec->bit_rate = bit_rate > 0 ? bit_rate : 2000000;
    e->codec->gop_size = (int)(fps > 0 ? fps : 30);  // ~1s keyframe interval
    e->codec->max_b_frames = 0;                      // latency-first
    if (codec->id == AV_CODEC_ID_H264) {
        // latency-first defaults; the user's YAML encoder argv (passed via
        // `options`) overrides them below, so existing ffmpeg tuning
        // (preset/profile/tune/crf/g/...) keeps working
        av_opt_set(e->codec->priv_data, "preset", "veryfast", 0);
        av_opt_set(e->codec->priv_data, "tune", "zerolatency", 0);
    }
    if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER) {
        e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    }
    AVDictionary* codec_dict = parse_options(options);
    err = avcodec_open2(e->codec, codec, &codec_dict);
    av_dict_free(&codec_dict);
    if (err < 0) {
        set_err(errbuf, errbuf_len, "codec open: " + av_errstr(err));
        avcodec_free_context(&e->codec);
        avformat_free_context(e->fmt);
        delete e;
        return nullptr;
    }

    e->stream = avformat_new_stream(e->fmt, nullptr);
    avcodec_parameters_from_context(e->stream->codecpar, e->codec);
    e->stream->time_base = e->codec->time_base;

    if (e->mem_sink) {
        const int io_buf_size = 32768;
        e->avio_buf = (uint8_t*)av_malloc(io_buf_size);
        e->avio = avio_alloc_context(e->avio_buf, io_buf_size, 1, e, nullptr,
                                     wt_mem_write, nullptr);
        e->fmt->pb = e->avio;
        e->fmt->flags |= AVFMT_FLAG_CUSTOM_IO;
    } else if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
        if ((err = avio_open(&e->fmt->pb, dest, AVIO_FLAG_WRITE)) < 0) {
            set_err(errbuf, errbuf_len, "avio_open: " + av_errstr(err));
            avcodec_free_context(&e->codec);
            avformat_free_context(e->fmt);
            delete e;
            return nullptr;
        }
    }

    if ((err = avformat_write_header(e->fmt, nullptr)) < 0) {
        set_err(errbuf, errbuf_len, "write_header: " + av_errstr(err));
        avcodec_free_context(&e->codec);
        avformat_free_context(e->fmt);
        delete e;
        return nullptr;
    }
    e->header_written = true;
    e->frame = av_frame_alloc();
    e->frame->format = AV_PIX_FMT_YUV420P;
    e->frame->width = w;
    e->frame->height = h;
    av_frame_get_buffer(e->frame, 0);
    e->pkt = av_packet_alloc();
    return e;
}

static int wt_encoder_drain(WtEncoder* e) {
    while (true) {
        int err = avcodec_receive_packet(e->codec, e->pkt);
        if (err == AVERROR(EAGAIN) || err == AVERROR_EOF) return 0;
        if (err < 0) return err;
        // one frame per tick of the codec time base; without an explicit
        // duration the mp4 demuxer drops the final sample on playback
        e->pkt->duration = 1;
        av_packet_rescale_ts(e->pkt, e->codec->time_base, e->stream->time_base);
        e->pkt->stream_index = e->stream->index;
        err = av_interleaved_write_frame(e->fmt, e->pkt);
        if (err < 0) return err;
    }
}

extern "C" int wt_encoder_write(WtEncoder* e, const uint8_t* rgb) {
    int64_t now = av_gettime_relative();
    if (e->input_fps > 0) {
        // `-r <fps> -vsync drop` on the rawvideo input: frames arriving
        // faster than the declared rate are dropped before any scaling
        int64_t period = (int64_t)(1e6 / e->input_fps);
        if (e->last_accept_us >= 0 &&
            now - e->last_accept_us < period - period / 20) {
            return 0;
        }
        e->last_accept_us = e->last_accept_us < 0 ? now
                            : e->last_accept_us + period;
        if (now - e->last_accept_us > period) e->last_accept_us = now;
    }
    int err = 0;
    if (e->cfr) {
        // `-vsync cfr`: stamp by wall clock at the output rate, duplicating
        // the previous frame across gaps and dropping when input outpaces
        if (e->cfr_start_us < 0) e->cfr_start_us = now;
        int64_t target = (int64_t)((now - e->cfr_start_us) * 1e-6
                                   * e->out_fps + 0.5);
        if (e->have_frame && target <= e->last_pts) return 0;  // too fast
        int64_t gap_start = e->last_pts + 1;
        if (e->have_frame && target > gap_start) {
            // cap the catch-up burst (e.g. after a long stall) at 2 seconds
            int64_t max_dup = (int64_t)(2 * e->out_fps);
            if (target - gap_start > max_dup) gap_start = target - max_dup;
            for (int64_t p = gap_start; p < target; ++p) {
                e->frame->pts = p;
                if ((err = avcodec_send_frame(e->codec, e->frame)) < 0)
                    return err;
                if ((err = wt_encoder_drain(e)) < 0) return err;
            }
        }
        e->next_pts = target;
    }
    e->sws = sws_getCachedContext(e->sws, e->w, e->h, AV_PIX_FMT_RGB24,
                                  e->w, e->h, AV_PIX_FMT_YUV420P,
                                  SWS_BILINEAR, nullptr, nullptr, nullptr);
    av_frame_make_writable(e->frame);
    const uint8_t* src[4] = {rgb, nullptr, nullptr, nullptr};
    int src_stride[4] = {e->w * 3, 0, 0, 0};
    sws_scale(e->sws, src, src_stride, 0, e->h, e->frame->data,
              e->frame->linesize);
    e->frame->pts = e->next_pts;
    e->last_pts = e->next_pts;
    e->next_pts++;
    e->have_frame = true;
    err = avcodec_send_frame(e->codec, e->frame);
    if (err < 0) return err;
    return wt_encoder_drain(e);
}

// Drain produced bytes (mem: sink only). Returns bytes copied.
extern "C" int wt_encoder_read_bytes(WtEncoder* e, uint8_t* buf, int cap) {
    std::lock_guard<std::mutex> lock(e->mem_mutex);
    int n = (int)std::min((size_t)cap, e->mem_buf.size());
    if (n > 0) {
        std::memcpy(buf, e->mem_buf.data(), n);
        e->mem_buf.erase(e->mem_buf.begin(), e->mem_buf.begin() + n);
    }
    return n;
}

extern "C" int wt_encoder_close(WtEncoder* e) {
    if (!e) return 0;
    int err = 0;
    if (e->header_written) {
        avcodec_send_frame(e->codec, nullptr);  // flush
        wt_encoder_drain(e);
        err = av_write_trailer(e->fmt);
    }
    if (e->sws) sws_freeContext(e->sws);
    av_frame_free(&e->frame);
    av_packet_free(&e->pkt);
    avcodec_free_context(&e->codec);
    if (e->mem_sink) {
        if (e->avio) {
            av_freep(&e->avio->buffer);
            avio_context_free(&e->avio);
        }
    } else if (e->fmt->pb && !(e->fmt->oformat->flags & AVFMT_NOFILE)) {
        avio_closep(&e->fmt->pb);
    }
    avformat_free_context(e->fmt);
    delete e;
    return err;
}

// ---------------------------------------------------------------------------
// JPEG encode (MJPEG codec): RGB24 -> JPEG bytes, for MJPEG HTTP streaming
// and snapshots.
//
// The streaming hot path uses a PERSISTENT encoder (wt_jpeg_ctx_*): codec +
// swscale contexts and the YUV staging frame are built once per (src, dst,
// quality) and reused for every frame, and the swscale pass DOWNSCALES and
// color-converts in one step — so a viewer served at 480x270 from a 1080p
// source pays one bandwidth-bound sws read of the frame plus a small DCT,
// not a full-res encode. The reference encodes per frame per viewer with
// cv2.imencode at source resolution (upstream watsor/output/
// video.py:118-149); this is the rebuild's improvement on that posture.
// Handles are NOT thread-safe; the Python JPEG cache serializes per handle.
// ---------------------------------------------------------------------------

struct JpegCtx {
    AVCodecContext* codec = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    int src_w = 0, src_h = 0;
    int64_t next_pts = 0;
};

extern "C" void wt_jpeg_ctx_close(void* handle) {
    JpegCtx* c = static_cast<JpegCtx*>(handle);
    if (!c) return;
    if (c->pkt) av_packet_free(&c->pkt);
    if (c->frame) av_frame_free(&c->frame);
    if (c->sws) sws_freeContext(c->sws);
    if (c->codec) avcodec_free_context(&c->codec);
    delete c;
}

extern "C" void* wt_jpeg_ctx_open(int src_w, int src_h, int out_w, int out_h,
                                  int quality) {
    const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MJPEG);
    if (!codec) return nullptr;
    if (out_w <= 0) out_w = src_w;
    if (out_h <= 0) out_h = src_h;
    // MJPEG 4:2:0 wants even dimensions
    out_w &= ~1;
    out_h &= ~1;
    JpegCtx* c = new JpegCtx();
    c->src_w = src_w;
    c->src_h = src_h;
    c->codec = avcodec_alloc_context3(codec);
    c->codec->width = out_w;
    c->codec->height = out_h;
    c->codec->pix_fmt = AV_PIX_FMT_YUVJ420P;
    c->codec->time_base = {1, 30};
    c->codec->flags |= AV_CODEC_FLAG_QSCALE;
    // map quality 1-100 to qscale 2-31 (lower = better)
    int q = 31 - (quality * 29) / 100;
    if (q < 2) q = 2;
    c->codec->global_quality = FF_QP2LAMBDA * q;
    if (avcodec_open2(c->codec, codec, nullptr) < 0) {
        wt_jpeg_ctx_close(c);
        return nullptr;
    }
    c->frame = av_frame_alloc();
    c->frame->format = c->codec->pix_fmt;
    c->frame->width = out_w;
    c->frame->height = out_h;
    if (av_frame_get_buffer(c->frame, 0) < 0) {
        wt_jpeg_ctx_close(c);
        return nullptr;
    }
    c->sws = sws_getContext(src_w, src_h, AV_PIX_FMT_RGB24, out_w, out_h,
                            c->codec->pix_fmt,
                            (out_w < src_w || out_h < src_h) ? SWS_AREA
                                                             : SWS_BILINEAR,
                            nullptr, nullptr, nullptr);
    c->pkt = av_packet_alloc();
    if (!c->sws || !c->pkt) {
        wt_jpeg_ctx_close(c);
        return nullptr;
    }
    return c;
}

extern "C" int wt_jpeg_ctx_encode(void* handle, const uint8_t* rgb,
                                  uint8_t* out, int out_cap) {
    JpegCtx* c = static_cast<JpegCtx*>(handle);
    if (!c) return -1;
    const uint8_t* src[4] = {rgb, nullptr, nullptr, nullptr};
    int src_stride[4] = {c->src_w * 3, 0, 0, 0};
    if (av_frame_make_writable(c->frame) < 0) return -3;
    sws_scale(c->sws, src, src_stride, 0, c->src_h, c->frame->data,
              c->frame->linesize);
    c->frame->quality = c->codec->global_quality;
    c->frame->pts = c->next_pts++;
    int err = avcodec_send_frame(c->codec, c->frame);
    if (err < 0) return err;
    err = avcodec_receive_packet(c->codec, c->pkt);
    if (err < 0) return err;
    int n = c->pkt->size <= out_cap ? c->pkt->size : -2;
    if (n > 0) std::memcpy(out, c->pkt->data, c->pkt->size);
    av_packet_unref(c->pkt);
    return n;
}

extern "C" int wt_jpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                              uint8_t* out, int out_cap) {
    void* c = wt_jpeg_ctx_open(w, h, w, h, quality);
    if (!c) return -1;
    int n = wt_jpeg_ctx_encode(c, rgb, out, out_cap);
    wt_jpeg_ctx_close(c);
    return n;
}

// ---------------------------------------------------------------------------
// Log drain: pops one captured libav message into buf. Returns the AV_LOG_*
// level (>= 0), or -1 when the ring is empty. Installing the callback is
// idempotent and also exported so Python can capture logs before the first
// decoder/encoder opens (e.g. open failures themselves).
// ---------------------------------------------------------------------------

extern "C" void wt_log_install() {
    av_log_set_callback(wt_log_callback);
}

extern "C" int wt_log_next(char* buf, int cap) {
    std::lock_guard<std::mutex> lock(g_log_mutex);
    if (g_log_ring.empty()) return -1;
    const LogEntry& entry = g_log_ring.front();
    std::snprintf(buf, cap, "%s", entry.msg.c_str());
    int level = entry.level;
    g_log_ring.pop_front();
    return level;
}

extern "C" const char* wt_version() {
    return "watsor-tpu-native 0.3 (" LIBAVFORMAT_IDENT ")";
}
