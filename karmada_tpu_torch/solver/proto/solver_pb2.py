# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: solver.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0csolver.proto\x12\x12karmada_tpu.solver\"3\n\x05Taint\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\"<\n\x12ResourceModelRange\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03min\x18\x02 \x01(\x03\x12\x0b\n\x03max\x18\x03 \x01(\x03\"V\n\rResourceModel\x12\r\n\x05grade\x18\x01 \x01(\x05\x12\x36\n\x06ranges\x18\x02 \x03(\x0b\x32&.karmada_tpu.solver.ResourceModelRange\"3\n\x13\x41llocatableModeling\x12\r\n\x05grade\x18\x01 \x01(\x05\x12\r\n\x05\x63ount\x18\x02 \x01(\x05\"\x8a\x06\n\x0c\x43lusterState\x12\x0c\n\x04name\x18\x01 \x01(\t\x12<\n\x06labels\x18\x02 \x03(\x0b\x32,.karmada_tpu.solver.ClusterState.LabelsEntry\x12)\n\x06taints\x18\x03 \x03(\x0b\x32\x19.karmada_tpu.solver.Taint\x12\x10\n\x08provider\x18\x04 \x01(\t\x12\x0e\n\x06region\x18\x05 \x01(\t\x12\x0c\n\x04zone\x18\x06 \x01(\t\x12\x17\n\x0f\x61pi_enablements\x18\x07 \x03(\t\x12\x1c\n\x14\x63omplete_enablements\x18\x08 \x01(\x08\x12\x46\n\x0b\x61llocatable\x18\t \x03(\x0b\x32\x31.karmada_tpu.solver.ClusterState.AllocatableEntry\x12\x42\n\tallocated\x18\n \x03(\x0b\x32/.karmada_tpu.solver.ClusterState.AllocatedEntry\x12\x44\n\nallocating\x18\x0b \x03(\x0b\x32\x30.karmada_tpu.solver.ClusterState.AllocatingEntry\x12:\n\x0fresource_models\x18\x0c \x03(\x0b\x32!.karmada_tpu.solver.ResourceModel\x12\x46\n\x15\x61llocatable_modelings\x18\r \x03(\x0b\x32\'.karmada_tpu.solver.AllocatableModeling\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41llocatableEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x1a\x30\n\x0e\x41llocatedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x1a\x31\n\x0f\x41llocatingEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\"c\n\x13SyncClustersRequest\x12\x32\n\x08\x63lusters\x18\x01 \x03(\x0b\x32 .karmada_tpu.solver.ClusterState\x12\x18\n\x10snapshot_version\x18\x02 \x01(\x04\"0\n\x14SyncClustersResponse\x12\x18\n\x10snapshot_version\x18\x01 \x01(\x04\"\xd8\x02\n\x0e\x42indingProblem\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x15\n\rplacement_idx\x18\x02 \x01(\x05\x12\x10\n\x08replicas\x18\x03 \x01(\x05\x12\x42\n\x08requests\x18\x04 \x03(\x0b\x32\x30.karmada_tpu.solver.BindingProblem.RequestsEntry\x12\x0b\n\x03gvk\x18\x05 \x01(\t\x12:\n\x04prev\x18\x06 \x03(\x0b\x32,.karmada_tpu.solver.BindingProblem.PrevEntry\x12\x16\n\x0e\x65vict_clusters\x18\x07 \x03(\t\x12\r\n\x05\x66resh\x18\x08 \x01(\x08\x1a/\n\rRequestsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x1a+\n\tPrevEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\"/\n\rTargetCluster\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08replicas\x18\x02 \x01(\x05\"\x8a\x01\n\x0eScheduleResult\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x33\n\x08\x63lusters\x18\x02 \x03(\x0b\x32!.karmada_tpu.solver.TargetCluster\x12\x10\n\x08\x66\x65\x61sible\x18\x03 \x03(\t\x12\x15\n\raffinity_name\x18\x04 \x01(\t\x12\r\n\x05\x65rror\x18\x05 \x01(\t\"\x80\x01\n\x15ScoreAndAssignRequest\x12\x17\n\x0fplacement_jsons\x18\x01 \x03(\t\x12\x34\n\x08problems\x18\x02 \x03(\x0b\x32\".karmada_tpu.solver.BindingProblem\x12\x18\n\x10snapshot_version\x18\x03 \x01(\x04\"g\n\x16ScoreAndAssignResponse\x12\x33\n\x07results\x18\x01 \x03(\x0b\x32\".karmada_tpu.solver.ScheduleResult\x12\x18\n\x10snapshot_version\x18\x02 \x01(\x04\x32\xd8\x01\n\x06Solver\x12\x63\n\x0cSyncClusters\x12\'.karmada_tpu.solver.SyncClustersRequest\x1a(.karmada_tpu.solver.SyncClustersResponse\"\x00\x12i\n\x0eScoreAndAssign\x12).karmada_tpu.solver.ScoreAndAssignRequest\x1a*.karmada_tpu.solver.ScoreAndAssignResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'solver_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CLUSTERSTATE_LABELSENTRY._options = None
  _CLUSTERSTATE_LABELSENTRY._serialized_options = b'8\001'
  _CLUSTERSTATE_ALLOCATABLEENTRY._options = None
  _CLUSTERSTATE_ALLOCATABLEENTRY._serialized_options = b'8\001'
  _CLUSTERSTATE_ALLOCATEDENTRY._options = None
  _CLUSTERSTATE_ALLOCATEDENTRY._serialized_options = b'8\001'
  _CLUSTERSTATE_ALLOCATINGENTRY._options = None
  _CLUSTERSTATE_ALLOCATINGENTRY._serialized_options = b'8\001'
  _BINDINGPROBLEM_REQUESTSENTRY._options = None
  _BINDINGPROBLEM_REQUESTSENTRY._serialized_options = b'8\001'
  _BINDINGPROBLEM_PREVENTRY._options = None
  _BINDINGPROBLEM_PREVENTRY._serialized_options = b'8\001'
  _TAINT._serialized_start=36
  _TAINT._serialized_end=87
  _RESOURCEMODELRANGE._serialized_start=89
  _RESOURCEMODELRANGE._serialized_end=149
  _RESOURCEMODEL._serialized_start=151
  _RESOURCEMODEL._serialized_end=237
  _ALLOCATABLEMODELING._serialized_start=239
  _ALLOCATABLEMODELING._serialized_end=290
  _CLUSTERSTATE._serialized_start=293
  _CLUSTERSTATE._serialized_end=1071
  _CLUSTERSTATE_LABELSENTRY._serialized_start=873
  _CLUSTERSTATE_LABELSENTRY._serialized_end=918
  _CLUSTERSTATE_ALLOCATABLEENTRY._serialized_start=920
  _CLUSTERSTATE_ALLOCATABLEENTRY._serialized_end=970
  _CLUSTERSTATE_ALLOCATEDENTRY._serialized_start=972
  _CLUSTERSTATE_ALLOCATEDENTRY._serialized_end=1020
  _CLUSTERSTATE_ALLOCATINGENTRY._serialized_start=1022
  _CLUSTERSTATE_ALLOCATINGENTRY._serialized_end=1071
  _SYNCCLUSTERSREQUEST._serialized_start=1073
  _SYNCCLUSTERSREQUEST._serialized_end=1172
  _SYNCCLUSTERSRESPONSE._serialized_start=1174
  _SYNCCLUSTERSRESPONSE._serialized_end=1222
  _BINDINGPROBLEM._serialized_start=1225
  _BINDINGPROBLEM._serialized_end=1569
  _BINDINGPROBLEM_REQUESTSENTRY._serialized_start=1477
  _BINDINGPROBLEM_REQUESTSENTRY._serialized_end=1524
  _BINDINGPROBLEM_PREVENTRY._serialized_start=1526
  _BINDINGPROBLEM_PREVENTRY._serialized_end=1569
  _TARGETCLUSTER._serialized_start=1571
  _TARGETCLUSTER._serialized_end=1618
  _SCHEDULERESULT._serialized_start=1621
  _SCHEDULERESULT._serialized_end=1759
  _SCOREANDASSIGNREQUEST._serialized_start=1762
  _SCOREANDASSIGNREQUEST._serialized_end=1890
  _SCOREANDASSIGNRESPONSE._serialized_start=1892
  _SCOREANDASSIGNRESPONSE._serialized_end=1995
  _SOLVER._serialized_start=1998
  _SOLVER._serialized_end=2214
# @@protoc_insertion_point(module_scope)
