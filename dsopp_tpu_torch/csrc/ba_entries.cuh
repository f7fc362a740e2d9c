// The C entries of K7, K8, K9 and K11 that ba_lm.cu::ba_solve_loop calls
// from C (the library links them into one object).  Their defining sources
// include this header too, so a definition that parts from its declaration
// here is a compile error ("conflicting declaration of C function"): C
// linkage checks no types across the library's objects.

#pragma once

extern "C" int ba_evaluate(const float* t_lin_q, const float* t_lin_t, const float* eps,
                           const float* affine0, const float* exposure, const float* lm_uv,
                           const float* idepth, const float* lm_patch,
                           const unsigned char* lm_mask, const unsigned char* frame_valid,
                           const int* res_status, const float* images, int image_stride, int k,
                           int n, int h, int w, int channels, float fx, float fy, float cx,
                           float cy, float width, float height, float sigma, const int* lm_state,
                           float* residuals, float* energy_patch, float* weight,
                           int* status_candidate, float* gx, float* gy, unsigned char* ok,
                           float* residuals1, float* energy_patch1, float* weight1,
                           int* status_candidate1, float* gx1, float* gy1, unsigned char* ok1,
                           unsigned char* mask_out, int seqs, const int* bank_seq,
                           const int* state_seq, void* stream);
extern "C" int ba_linearize_schur(
    const float* t_lin_q, const float* t_lin_t, const float* affine0, const float* exposure,
    const float* lm_uv, const float* lin_idepth, const float* lm_patch, float fx, float fy,
    float cx, float cy, float width, float height, const float* residuals,
    const float* weight, const float* gx, const float* gy, const unsigned char* ok,
    const float* residuals1, const float* weight1, const float* gx1, const float* gy1,
    const unsigned char* ok1, const float* eps, const unsigned char* frame_valid,
    const unsigned char* frame_fixed, const unsigned char* frame_marg, int k, int n,
    int channels, int marg_pass, float threshold, float scale_reg, float fixed_reg,
    float affine_reg_a, float affine_reg_b, int tiles, const int* lm_state, double* pair_part,
    float* lm_part, double* schur_part, float* h_out, float* b_out, float* h_schur,
    float* b_schur, float* hpd, float* inv_hdd, float* b_d, int seqs, const int* bank_seq,
    const int* state_seq, void* stream);
extern "C" int ba_solve_step(const float* h_pose, const float* b_pose, const float* h_schur,
                             const float* b_schur, const double* h_marg, const double* b_marg,
                             const float* eps, const float* idepth,
                             const unsigned char* frame_valid, const float* hpd,
                             const float* inv_hdd, const float* b_d, int k, int n, float lam,
                             int blocks, const int* lm_state, float* step, float* d_part,
                             double* system, float* eps_new, float* idepth_new, float* step_sq,
                             int seqs, const int* bank_seq, const int* state_seq, void* stream);
extern "C" int ba_point_status(const float* energy, const unsigned char* ok,
                               const int* candidate, const float* t_lin_q, const float* t_lin_t,
                               const float* eps, const float* lm_idepth,
                               const unsigned char* lm_mask, const float* old_baseline,
                               const unsigned char* old_outlier, const int* old_opt_count,
                               int k, int n, float quantile, float sigma, int min_valid,
                               void* workspace, int workspace_bytes,
                               unsigned int* candidates, float* thresh,
                               int* new_status, float* baseline, int* inliers,
                               unsigned char* outlier, int* opt_count, int seqs,
                               const int* bank_seq, const int* state_seq, void* stream);
