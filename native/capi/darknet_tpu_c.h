/* darknet_tpu C ABI — mirrors the reference's public surface
 * (yolo_core.h:625-663: LoadNetwork / NetworkPredict / GetNetworkBoxes /
 * NmsSort / FreeDetections) for C/C++ clients of the JAX runtime.
 *
 * The implementation embeds CPython and drives the darknet_tpu package;
 * the compute runs wherever JAX is configured (the GPU when JAX has one;
 * set DTPU_PLATFORM=cpu to force CPU).  All calls are GIL-safe.
 */
#ifndef DARKNET_TPU_C_H
#define DARKNET_TPU_C_H

#ifdef __cplusplus
extern "C" {
#endif

typedef void* dtpu_net;

typedef struct {
  /* relative center-format box, like the reference Detection (box.h:68) */
  float x, y, w, h;
  float objectness;
  int best_class;
  float best_prob;
} dtpu_detection;

/* LoadNetwork: parse cfg, optionally load .weights (NULL -> random init),
 * fuse BN for inference.  Returns NULL on failure. */
dtpu_net dtpu_load(const char* cfg_path, const char* weights_path);

/* LoadNetwork with the full reference signature (yolo_core.h:625-626):
 * train != 0 keeps BN unfused (required before dtpu_save_weights);
 * clear != 0 resets the seen counter. */
dtpu_net dtpu_load2(const char* cfg_path, const char* weights_path,
                    int train, int clear);

/* Network input geometry. */
int dtpu_input_w(dtpu_net net);
int dtpu_input_h(dtpu_net net);
int dtpu_input_c(dtpu_net net);
int dtpu_classes(dtpu_net net);

/* NetworkPredict + GetNetworkBoxes + NmsSort in one call.
 * rgb: HWC float32 in [0,1] with the network's input dims.
 * Returns the number of detections written (<= max_out), or -1 on error. */
int dtpu_detect(dtpu_net net, const float* rgb, float thresh, float nms,
                dtpu_detection* out, int max_out);

/* SaveWeights: write the byte-exact .weights stream (parser.cpp:1590).
 * Returns 0 on success, -1 on error. */
int dtpu_save_weights(dtpu_net net, const char* path);

/* Detection2Json (network.cpp:531-593): run detect and return the JSON
 * string for the frame.  Caller frees with dtpu_free_str.  NULL on
 * error.  filename may be NULL. */
char* dtpu_detect_json(dtpu_net net, const float* rgb, float thresh,
                       float nms, long long frame_id, const char* filename);
void dtpu_free_str(char* s);

/* ValidateDetector (detector.cpp:326-561): mAP@iou_thresh over the
 * .data file's valid list using an already-loaded net.  Returns mAP in
 * [0,1], or -1.0 on error. */
float dtpu_validate(dtpu_net net, const char* data_file, float iou_thresh);

/* FreeNetwork. */
void dtpu_free(dtpu_net net);

/* TrainDetector (yolo_core.h:640-642, detector.cpp:27-324): run the full
 * training loop driven by the .data file (train list, backup dir for
 * checkpoints).  weights_path may be NULL/"" (random init); clear != 0
 * resets the seen counter; max_iters > 0 bounds the run (0 = the cfg's
 * max_iter).  Returns the final EMA avg loss (-1.0 when zero iterations
 * ran, e.g. the loaded weights already reached max_iter), or NaN on
 * error — check with isnan(). */
float dtpu_train(const char* data_file, const char* cfg_path,
                 const char* weights_path, int clear, int max_iters);

/* ---- multi-object tracker (track_manager.h — part of the reference's
 * installed library surface, CMakeLists.txt:265): Kalman filter +
 * Hungarian association over per-frame best-class detections. ---- */

typedef void* dtpu_tracker;

typedef struct {
  float x, y, w, h;  /* relative center-format bbox */
  int cid;           /* class id */
  float prob;
  int label;         /* stable id, assigned after min_conf frames (-1 early) */
  int stationary;    /* 1 when STATIONARY (track_manager.cpp:100-113) */
} dtpu_track_info;

/* TrackManager(ConfParam::from_fps(fps), fps, iou_thresh)
 * (yolo_core.cpp:244-246 derives ConfParam from the stream fps). */
dtpu_tracker dtpu_tracker_new(float fps, float iou_thresh);

/* TrackManager::Track for ONE frame's detections (e.g. dtpu_detect
 * output).  Returns 0, or -1 on error. */
int dtpu_tracker_update(dtpu_tracker t, const dtpu_detection* dets, int n);

/* Confirmed tracks (conf >= min_conf, TrackManager::GetTracks).  Returns
 * the number written (<= max_out), or -1 on error. */
int dtpu_tracker_tracks(dtpu_tracker t, dtpu_track_info* out, int max_out);

void dtpu_tracker_free(dtpu_tracker t);

#ifdef __cplusplus
}
#endif
#endif /* DARKNET_TPU_C_H */
