// Golden-value harness: reference pixel-selector block thresholds
// (PixelSelector::makeHists, PixelSelector2.cpp:69-145) + makeImages
// gradients vs sos_slam_tpu/ops/{image,selector}.py.
//
// The selection map itself is NOT compared (the JAX build documents an RNG
// deviation for the per-block random directions); the deterministic surface
// — gradient pyramid level 0 and the 32x32 histogram-quantile thresholds —
// is compared bitwise-reproducibly from an integer-derived test image.
#include "FullSystem/HessianBlocks.h"
#include "util/FrameShell.h"
#include "util/globalCalib.h"
#include "util/settings.h"
#include <cstdio>
#include <vector>
// expose ths/thsSmoothed for golden readout; all std/Eigen headers are
// already included above so the access hack only affects PixelSelector2.h
#define private public
#include "FullSystem/PixelSelector2.h"
#undef private

using namespace dso;

int dso::FrameHessian::instanceCounter = 0;
int dso::CalibHessian::instanceCounter = 0;

static const int W = 256, H = 192;

int main() {
  Eigen::Matrix3f K;
  K << 200.f, 0.f, 128.f, 0.f, 200.f, 96.f, 0.f, 0.f, 1.f;
  setGlobalCalib(W, H, K);
  setting_gammaWeightsPixelSelect = 0;   // no gamma weighting in this test

  // deterministic test image from integer arithmetic (bitwise reproducible
  // in numpy): ramp + hash noise
  std::vector<float> img(W * H);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      int ramp = (x * 7 + y * 13) % 97;
      int noise = (int)(((unsigned)(x * 73856093) ^ (unsigned)(y * 19349663))
                        % 29u);
      img[x + y * W] = 0.5f * (float)ramp + (float)noise;
    }

  FrameHessian *fh = new FrameHessian();
  fh->makeImages(img.data(), nullptr);

  // absSquaredGrad[0] checksum + samples over INTERIOR pixels only (the
  // reference leaves row 0 / row H-1 uninitialized and computes the x
  // borders with wrap-around neighbours; makeHists masks all of them)
  double s = 0.0;
  for (int y = 1; y < H - 1; y++)
    for (int x = 1; x < W - 1; x++) s += fh->absSquaredGrad[0][x + y * W];
  printf("asg_sum %.17g\n", s);
  for (int y = 1; y < H - 1; y += 37)
    for (int x = 1; x < W - 1; x += 41)
      printf("asg %d %d %.9g\n", x, y, fh->absSquaredGrad[0][x + y * W]);

  PixelSelector ps(W, H);
  ps.makeHists(fh);
  int w32 = W / 32, h32 = H / 32;
  for (int y = 0; y < h32; y++)
    for (int x = 0; x < w32; x++)
      printf("ths %d %d %.9g %.9g\n", x, y, ps.ths[x + y * w32],
             ps.thsSmoothed[x + y * w32]);
  return 0;
}
