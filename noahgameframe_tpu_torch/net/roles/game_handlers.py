"""The game role's client handlers: role CRUD, enter and leave, the
object-entry snapshots, move, chat, skill, the middleware handlers (items,
equipment, tasks, teams, guilds, GM commands, PVP, SLG), all dispatched
from the handler table :meth:`GameRole._install` registers.

Counterpart of ``noahgameframe_tpu/net/roles/game.py:871-1590`` and
``:1791-1870``.  On a world without the middleware stack
(``WorldConfig(middleware=False)``, as the bench worlds are) the middleware
handlers find their module ``None`` and do nothing, as the JAX role does
on such a world.
"""

from __future__ import annotations

from typing import List, Optional

from ..defines import EventCode, MsgID
from ..transport import EV_DISCONNECTED
from ..wire import (
    AckEventResult,
    AckPlayerEntryList,
    AckPlayerLeaveList,
    AckRoleLiteInfoList,
    Ident,
    MsgBase,
    ObjectPropertyList,
    ObjectRecordList,
    PlayerEntryInfo,
    ReqAcceptTask,
    ReqAckCreateGuild,
    ReqAckCreateTeam,
    ReqAckJoinGuild,
    ReqAckJoinTeam,
    ReqAckLeaveGuild,
    ReqAckLeaveTeam,
    ReqAckOprTeamMember,
    ReqAckPlayerChat,
    ReqAckPlayerMove,
    ReqAckSwapScene,
    ReqAckUseItem,
    ReqAckUseSkill,
    ReqCompeleteTask,
    ReqCreateRole,
    ReqDeleteRole,
    ReqEnterGameServer,
    ReqRoleList,
    ReqSearchGuild,
    ReqSetFightHero,
    ReqWearEquip,
    AckSearchGuild,
    RoleLiteInfo,
    SearchGuildObject,
    TakeOffEquip,
    TeamInfo,
    TeammemberInfo,
    ident_key as _ident_key,
    unwrap,
    wrap,
)
from ...core.datatypes import DataType, Guid
from ...persist.codec import serialize_properties, serialize_records
from .game_session import Session, guid_ident, ROW_TARGET_SVRID


class GameHandlersMixin:
    # ------------------------------------------------------------ role CRUD
    def _session_for(self, conn_id: int, base: MsgBase) -> Session:
        key = _ident_key(base.player_id)
        sess = self.sessions.get(key)
        if sess is None:
            sess = Session(ident=base.player_id or Ident(), conn_id=conn_id)
            self.sessions[key] = sess
        sess.conn_id = conn_id
        return sess

    def _get_roles(self, account: str) -> List[RoleLiteInfo]:
        roles = self.roles.get(account)
        if roles is None:
            roles = (self.role_store.load(account)
                     if self.role_store is not None else [])
            self.roles[account] = roles
        return roles

    def _put_roles(self, account: str, roles: List[RoleLiteInfo]) -> None:
        self.roles[account] = roles
        if self.role_store is not None:
            self.role_store.save(account, roles)

    def _on_role_list(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqRoleList)
        sess = self._session_for(conn_id, base)
        sess.account = req.account.decode("utf-8", "replace") or sess.account
        ack = AckRoleLiteInfoList(char_data=self._get_roles(sess.account))
        self._send_to_session(sess, MsgID.ACK_ROLE_LIST, ack)

    def _on_create_role(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqCreateRole)
        sess = self._session_for(conn_id, base)
        account = req.account.decode("utf-8", "replace") or sess.account
        sess.account = account
        roles = self._get_roles(account)
        name = req.noob_name
        if any(r.noob_name == name for r in roles):
            code = int(EventCode.CHARACTER_EXIST)
        else:
            roles.append(
                RoleLiteInfo(
                    id=guid_ident(self.kernel.store.guids.next()),
                    career=req.career,
                    sex=req.sex,
                    race=req.race,
                    noob_name=name,
                    game_id=req.game_id,
                    role_level=1,
                )
            )
            self._put_roles(account, roles)
            code = int(EventCode.SUCCESS)
        self._send_to_session(
            sess, MsgID.EVENT_RESULT, AckEventResult(event_code=code)
        )
        # the reference replies with the refreshed role list either way
        ack = AckRoleLiteInfoList(char_data=roles)
        self._send_to_session(sess, MsgID.ACK_ROLE_LIST, ack)

    def _on_delete_role(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqDeleteRole)
        sess = self._session_for(conn_id, base)
        account = req.account.decode("utf-8", "replace") or sess.account
        remaining = [r for r in self._get_roles(account)
                     if r.noob_name != req.name]
        self._put_roles(account, remaining)
        if self.data_agent is not None:
            name = req.name.decode("utf-8", "replace")
            self.data_agent.delete(f"{account}:{name}")
        self._send_to_session(
            sess, MsgID.ACK_ROLE_LIST,
            AckRoleLiteInfoList(char_data=remaining),
        )

    # ------------------------------------------------------------ enter/leave
    def _on_enter_game(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqEnterGameServer)
        sess = self._session_for(conn_id, base)
        sess.account = req.account.decode("utf-8", "replace") or sess.account
        if sess.guid is not None:
            self._despawn(sess)  # re-entry replaces the old avatar
        name = req.name.decode("utf-8", "replace")
        store = self.kernel.store
        if store.live_count("Player") >= store.capacity("Player"):
            # world full: refuse gracefully BEFORE allocating, so no row
            # leaks and the pump keeps serving — the reference answers
            # with an event-result code on every enter-game failure path.
            # Other create failures propagate to the dispatch isolation
            # layer (logged + message dropped).
            self._send_to_session(
                sess,
                MsgID.ACK_ENTER_GAME,
                AckEventResult(event_code=int(EventCode.CHARACTER_NUMOUT)),
            )
            return
        guid = self.kernel.create_object(
            "Player",
            {"Name": name, "Account": sess.account, "GameID": self.config.server_id},
            scene=0,
            group=0,
        )
        sess.guid = guid
        self._guid_session[guid] = _ident_key(sess.ident)
        # stat init: fresh players get level 1 + full refill; returning
        # players keep their loaded Level/HP (the data agent attached the
        # saved blob during CREATE_LOADDATA) and only the derived stats
        # are rebuilt (reference OnObjectLevelEvent → RefreshBaseProperty)
        gw = self.game_world
        loaded = (self.data_agent is not None and sess.account
                  and self.data_agent.exists(f"{sess.account}:{name}"))
        if not loaded:
            self.kernel.set_property(guid, "Level", 1)
        gw.properties.refresh_base_property(guid, gw.property_config)
        gw.properties.recompute_now(guid)
        if not loaded:
            gw.properties.full_hp_mp(guid)
            gw.properties.full_sp(guid)
        # enter-scene pipeline (RequestEnterScene semantics; clone scenes
        # mint a private instance via SceneProcessModule)
        self._enter_scene(guid, self.scene_id)
        ack = AckEventResult(
            event_code=int(EventCode.ENTER_GAME_SUCCESS),
            event_object=guid_ident(guid),
        )
        self._send_to_session(sess, MsgID.ACK_ENTER_GAME, ack)
        self._send_snapshots(sess)
        if self.cross_server_sync:
            self._notify_online(sess, guid, self.scene_id, 0)

    def _notify_online(self, sess: Session, guid: Guid,
                       scene_id: int, group_id: int) -> None:
        """Cross-server online notify + session-bind sidecar:
        the world's roster learns the player came online, and its
        failover supervisor learns everything needed to re-home this session
        — durable save key included — should this role die unasked."""
        from ..wire import RoleOnlineNotify, SessionBindNotify

        ident = guid_ident(guid)
        self.world_link.send_to_all(
            int(MsgID.ACK_ONLINE_NOTIFY),
            wrap(RoleOnlineNotify(), player_id=ident),
        )
        save_key = ""
        if self.data_agent is not None:
            save_key = self.data_agent._key_of(guid) or ""
        bind = SessionBindNotify(
            selfid=ident,
            account=(sess.account or "").encode(),
            name=str(self.kernel.get_property(guid, "Name") or "").encode(),
            client_id=sess.ident,
            scene_id=int(scene_id),
            group_id=int(group_id),
            save_key=save_key.encode(),
            game_id=int(self.config.server_id),
        )
        self.world_link.send_to_all(
            int(MsgID.SESSION_BIND_NOTIFY), wrap(bind)
        )

    def _on_leave_game(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, _ = unwrap(body)
        key = _ident_key(base.player_id)
        sess = self.sessions.pop(key, None)
        if sess is not None:
            self._despawn(sess)

    def reset_view(self, sess: Session) -> dict:
        """Forget everything this session's client mirrors: fresh legacy
        seen-dict AND a wiped device seen-state row (batched engine).
        The single chokepoint for every view reset — despawn, switch-out,
        out-of-band destroy, and the lazy first-serve init all route
        here so the two engines can never drift on reset semantics."""
        seen = sess._interest_seen = {}
        self._session_table.reset_view(_ident_key(sess.ident))
        return seen

    def _despawn(self, sess: Session) -> None:
        if sess.guid is None:
            return
        guid = sess.guid
        targets = self._scene_players(guid)
        sess.guid = None
        # the interest seen-state belongs to the AVATAR's view: a fresh
        # client (crash + reconnect) starts with an empty mirror, so a
        # stale seen-state would suppress every stationary entity forever
        self.reset_view(sess)
        self._guid_session.pop(guid, None)
        # PVP hygiene: a queued ticket would ghost-match a gone player,
        # and an unconsumed room entry would leak forever
        pvp = getattr(self.game_world, "pvp", None)
        if pvp is not None:
            pvp.leave_queue(guid)
        for rid, pair in list(self._pvp_rooms.items()):
            if guid in pair:
                del self._pvp_rooms[rid]
                # the surviving fighter must hear the match died, or
                # they wait on a room that can never mint its ectype
                for other in pair:
                    if other == guid:
                        continue
                    key = self._guid_session.get(other)
                    s2 = self.sessions.get(key) if key is not None else None
                    if s2 is not None:
                        from ..wire import AckPVPApplyMatch

                        self._send_to_session(
                            s2, MsgID.ACK_PVP_APPLY_MATCH,
                            AckPVPApplyMatch(nResult=0),  # cancelled
                        )
        if guid in self.kernel.store.guid_map:
            self.kernel.destroy_object(guid)
        leave = AckPlayerLeaveList(object_list=[guid_ident(guid)])
        self._broadcast(targets, MsgID.ACK_OBJECT_LEAVE, leave, exclude=guid)
        if self.cross_server_sync:
            from ..wire import RoleOfflineNotify

            self.world_link.send_to_all(
                int(MsgID.ACK_OFFLINE_NOTIFY),
                wrap(RoleOfflineNotify(), player_id=guid_ident(guid)),
            )

    def _on_socket(self, conn_id: int, kind: int) -> None:
        if kind != EV_DISCONNECTED:
            return
        # a proxy link died: all its clients are gone
        for key, sess in list(self.sessions.items()):
            if sess.conn_id == conn_id:
                self._despawn(sess)
                self.sessions.pop(key, None)

    # ------------------------------------------------------------ snapshots
    def _entry_info(self, guid: Guid) -> PlayerEntryInfo:
        k = self.kernel
        cname, _ = k.store.row_of(guid)
        pos = k.get_property(guid, "Position")
        cfg = ""
        if k.store.spec(cname).has_property("ConfigID"):
            cfg = str(k.get_property(guid, "ConfigID"))
        return PlayerEntryInfo(
            object_guid=guid_ident(guid),
            x=pos[0], y=pos[1], z=pos[2] if len(pos) > 2 else 0.0,
            scene_id=int(k.get_property(guid, "SceneID")),
            class_id=cname.encode(),
            config_id=cfg.encode(),
        )

    def _property_list(self, guid: Guid, include_private: bool) -> ObjectPropertyList:
        """Full property snapshot (OnPropertyEnter: Public to others,
        Public+Private to self) via the shared serializer."""
        pred = (lambda d: d.flag("public") or d.flag("private")) \
            if include_private else (lambda d: d.flag("public"))
        out = serialize_properties(self.kernel.store, self.kernel.state,
                                   guid, pred)
        out.player_id = guid_ident(guid)
        return out

    def _record_list(self, guid: Guid, include_private: bool) -> ObjectRecordList:
        """Record snapshot for the flag-visible records (OnRecordEnter)
        via the shared serializer."""
        pred = (lambda d: d.flag("public") or d.flag("private")) \
            if include_private else (lambda d: d.flag("public"))
        out = serialize_records(self.kernel.store, self.kernel.state,
                                guid, pred)
        out.player_id = guid_ident(guid)
        return out

    def _send_snapshots(self, sess: Session) -> None:
        """Object-entry choreography toward the new client + the rest of
        the group (OnObjectListEnter / OnPropertyEnter / OnRecordEnter)."""
        guid = sess.guid
        visible: List[Guid] = []
        for cname in self.sync_classes:
            visible.extend(
                self.scene.objects_in_group(self.scene_id, 1, cname)
            )
        entry_all = AckPlayerEntryList(
            object_list=[self._entry_info(g) for g in visible]
        )
        self._send_to_session(sess, MsgID.ACK_OBJECT_ENTRY, entry_all)
        for g in visible:
            self._send_to_session(
                sess, MsgID.ACK_OBJECT_PROPERTY_ENTRY,
                self._property_list(g, include_private=(g == guid)),
            )
        self._send_to_session(
            sess, MsgID.ACK_OBJECT_RECORD_ENTRY,
            self._record_list(guid, include_private=True),
        )
        # announce the newcomer to everyone already there
        entry_self = AckPlayerEntryList(object_list=[self._entry_info(guid)])
        others = self._scene_players(guid)
        self._broadcast(others, MsgID.ACK_OBJECT_ENTRY, entry_self, exclude=guid)
        self._broadcast(
            others, MsgID.ACK_OBJECT_PROPERTY_ENTRY,
            self._property_list(guid, include_private=False), exclude=guid,
        )

    # ------------------------------------------------------------ gameplay
    def _enter_scene(self, guid, scene_id: int, group: int = 1) -> int:
        """Enter routed by scene type (NFCSceneProcessModule semantics):
        clone scenes mint a private instance for the enterer, normal
        scenes share `group` (created on first use)."""
        if scene_id not in self.scene.scenes:
            self.scene.create_scene(scene_id)
        sp = getattr(self.game_world, "scene_process", None)
        if sp is not None:
            return sp.enter(guid, scene_id, group)
        if group not in self.scene.scenes[scene_id].groups:
            self.scene.request_group(scene_id, group_id=group)
        self.scene.enter_scene(guid, scene_id, group)
        return group

    def _on_swap_scene(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqAckSwapScene)
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None:
            return
        self._enter_scene(sess.guid, req.scene_id)
        self._send_to_session(sess, MsgID.ACK_SWAP_SCENE, req)

    def _on_move(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqAckPlayerMove)
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None or not req.target_pos:
            return
        p = req.target_pos[0]
        self.kernel.set_property(sess.guid, "Position", (p.x, p.y, p.z))
        req.mover = guid_ident(sess.guid)
        self._broadcast(self._scene_players(sess.guid), MsgID.ACK_MOVE, req)

    def _on_chat(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqAckPlayerChat)
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None:
            return
        req.chat_id = guid_ident(sess.guid)
        self._broadcast(self._scene_players(sess.guid), MsgID.ACK_CHAT, req)

    def _on_skill(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        """Host-path skill resolution (`NFCSkillModule::OnUseSkill`
        HP-damage semantics, `NFCSkillModule.cpp:74-160`); batch AoE lives
        in game/combat.py on device."""
        base, req = unwrap(body, ReqAckUseSkill)
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None:
            return
        req.user = guid_ident(sess.guid)
        for eff in req.effect_data:
            target = self._guid_of_ident(eff.effect_ident)
            if target is None or target not in self.kernel.store.guid_map:
                continue
            hp = int(self.kernel.get_property(target, "HP"))
            dmg = self.skill_damage
            self.kernel.set_property(target, "HP", max(0, hp - dmg))
            eff.effect_value = dmg
        self._broadcast(self._scene_players(sess.guid), MsgID.ACK_SKILL_OBJECTX, req)

    def _guid_of_ident(self, ident: Optional[Ident]) -> Optional[Guid]:
        if ident is None:
            return None
        return Guid(ident.svrid, ident.index)

    def _on_set_fight_hero(self, conn_id: int, _msg_id: int,
                           body: bytes) -> None:
        """NFCHeroModule::OnSetFightHeroMsg — the hero's record row rides
        heroid.index (heroes are row-identified)."""
        base, req = unwrap(body, ReqSetFightHero)
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None or req.heroid is None:
            return
        heroes = self.game_world.heroes
        if heroes is not None:
            heroes.set_fight_hero(sess.guid, int(req.heroid.index),
                                  int(req.fight_pos))

    # ---------------------------------------------- middleware handlers
    # reference: NFCItemModule::OnClientUseItem, NFCEquipModule wear /
    # takeoff callbacks, NFCTaskModule::OnClientAcceptTask /
    # OnClientCompeleteTask, NFCTeamModule and the guild handlers.  All
    # degrade to no-ops when the world was assembled without the
    # middleware stack (bench worlds).
    def _mid_session(self, base) -> Optional[Session]:
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None:
            return None
        return sess

    def _on_use_item(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqAckUseItem)
        sess = self._mid_session(base)
        items = self.game_world.items
        if sess is None or items is None or req.item is None:
            return
        config_id = req.item.item_id.decode("utf-8", "replace")
        # row targets are tagged with svrid == 1 (ROW_TARGET_SVRID): row 0
        # is a VALID first record row, and protoc clients always send the
        # required targetid field (zeroed when untargeted), so the index
        # alone cannot discriminate "no target" from "row 0"
        target = (int(req.targetid.index)
                  if (req.targetid is not None
                      and int(req.targetid.svrid) == ROW_TARGET_SVRID)
                  else None)
        if items.use_item(sess.guid, config_id, target=target):
            req.user = guid_ident(sess.guid)
            self._send_to_session(sess, MsgID.ACK_ITEM_OBJECT, req)

    def _on_wear_equip(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqWearEquip)
        sess = self._mid_session(base)
        equip = self.game_world.equip
        if sess is None or equip is None or req.equipid is None:
            return
        equip.wear(sess.guid, int(req.equipid.index))

    def _on_takeoff_equip(self, conn_id: int, _msg_id: int,
                          body: bytes) -> None:
        base, req = unwrap(body, TakeOffEquip)
        sess = self._mid_session(base)
        equip = self.game_world.equip
        if sess is None or equip is None or req.equipid is None:
            return
        equip.take_off(sess.guid, int(req.equipid.index))

    def _on_accept_task(self, conn_id: int, _msg_id: int,
                        body: bytes) -> None:
        base, req = unwrap(body, ReqAcceptTask)
        sess = self._mid_session(base)
        tasks = self.game_world.tasks
        if sess is None or tasks is None:
            return
        tasks.accept(sess.guid, req.task_id.decode("utf-8", "replace"))

    def _on_complete_task(self, conn_id: int, _msg_id: int,
                          body: bytes) -> None:
        base, req = unwrap(body, ReqCompeleteTask)
        sess = self._mid_session(base)
        tasks = self.game_world.tasks
        if sess is None or tasks is None:
            return
        tasks.draw_award(sess.guid, req.task_id.decode("utf-8", "replace"))

    # ------------------------------------------------------------- teams
    def _team_info(self, info) -> "TeamInfo":
        k = self.kernel
        members = []
        for m in info.members:
            if m not in k.store.guid_map:
                continue
            members.append(TeammemberInfo(
                player_id=guid_ident(m),
                name=str(k.get_property(m, "Name")).encode(),
                nLevel=int(k.get_property(m, "Level")),
                job=int(k.get_property(m, "Job")),
            ))
        return TeamInfo(
            team_id=guid_ident(info.group_id),
            captain_id=guid_ident(info.leader),
            teammemberInfo=members,
        )

    def _on_create_team(self, conn_id: int, _msg_id: int,
                        body: bytes) -> None:
        base, _req = unwrap(body, ReqAckCreateTeam)
        sess = self._mid_session(base)
        team = self.game_world.team
        if sess is None or team is None:
            return
        tid = team.create_team(sess.guid)
        if tid is None:
            return
        info = team.team_of(sess.guid)
        self._send_to_session(
            sess, MsgID.ACK_CREATE_TEAM,
            ReqAckCreateTeam(team_id=guid_ident(tid),
                             xTeamInfo=self._team_info(info)),
        )

    def _on_join_team(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        base, req = unwrap(body, ReqAckJoinTeam)
        sess = self._mid_session(base)
        team = self.game_world.team
        if sess is None or team is None or req.team_id is None:
            return
        tid = self._guid_of_ident(req.team_id)
        if not team.join(tid, sess.guid):
            return
        info = team.team_of(sess.guid)
        ack = ReqAckJoinTeam(team_id=req.team_id,
                             xTeamInfo=self._team_info(info))
        # the whole roster hears about the new member
        self._broadcast(list(info.members), MsgID.ACK_JOIN_TEAM, ack)

    def _on_leave_team(self, conn_id: int, _msg_id: int,
                       body: bytes) -> None:
        base, req = unwrap(body, ReqAckLeaveTeam)
        sess = self._mid_session(base)
        team = self.game_world.team
        if sess is None or team is None:
            return
        info = team.team_of(sess.guid)
        if info is None or not team.leave(sess.guid):
            return
        ack = ReqAckLeaveTeam(team_id=guid_ident(info.group_id))
        self._broadcast(list(info.members) + [sess.guid],
                        MsgID.ACK_LEAVE_TEAM, ack)

    def _on_opr_team_member(self, conn_id: int, _msg_id: int,
                            body: bytes) -> None:
        """Captain member ops — KICK/KICKOUT implemented (the other
        EGTeamMemberOprType values are fight-position bookkeeping the
        line-up record owns here)."""
        base, req = unwrap(body, ReqAckOprTeamMember)
        sess = self._mid_session(base)
        team = self.game_world.team
        if sess is None or team is None or req.member_id is None:
            return
        if int(req.type) not in (2, 8):  # EGAT_KICK / EGAT_KICKOUT
            return
        info = team.team_of(sess.guid)
        if info is None or info.leader != sess.guid:
            return  # only the captain operates members
        member = self._guid_of_ident(req.member_id)
        if member == sess.guid or member not in info.members:
            return
        team.leave(member)
        ack = ReqAckOprTeamMember(team_id=guid_ident(info.group_id),
                                  member_id=req.member_id, type=req.type,
                                  xTeamInfo=self._team_info(info))
        self._broadcast(list(info.members) + [member],
                        MsgID.ACK_OPRMEMBER_TEAM, ack)

    # ------------------------------------------------------------ guilds
    def _on_create_guild(self, conn_id: int, _msg_id: int,
                         body: bytes) -> None:
        base, req = unwrap(body, ReqAckCreateGuild)
        sess = self._mid_session(base)
        guilds = self.game_world.guilds
        if sess is None or guilds is None:
            return
        name = req.guild_name.decode("utf-8", "replace")
        gid = guilds.create_guild(sess.guid, name)
        if gid is None:
            return
        self._send_to_session(
            sess, MsgID.ACK_CREATE_GUILD,
            ReqAckCreateGuild(guild_id=guid_ident(gid),
                              guild_name=req.guild_name),
        )

    def _on_join_guild(self, conn_id: int, _msg_id: int,
                       body: bytes) -> None:
        base, req = unwrap(body, ReqAckJoinGuild)
        sess = self._mid_session(base)
        guilds = self.game_world.guilds
        if sess is None or guilds is None:
            return
        name = req.guild_name.decode("utf-8", "replace")
        info = guilds.find_by_name(name)
        if info is None or not guilds.join(info.group_id, sess.guid):
            return
        self._send_to_session(
            sess, MsgID.ACK_JOIN_GUILD,
            ReqAckJoinGuild(guild_id=guid_ident(info.group_id),
                            guild_name=req.guild_name),
        )

    def _on_leave_guild(self, conn_id: int, _msg_id: int,
                        body: bytes) -> None:
        base, req = unwrap(body, ReqAckLeaveGuild)
        sess = self._mid_session(base)
        guilds = self.game_world.guilds
        if sess is None or guilds is None:
            return
        info = guilds.guild_of(sess.guid)
        if info is None or not guilds.leave(sess.guid):
            return
        self._send_to_session(
            sess, MsgID.ACK_LEAVE_GUILD,
            ReqAckLeaveGuild(guild_id=guid_ident(info.group_id),
                             guild_name=info.name.encode()),
        )

    def _on_search_guild(self, conn_id: int, _msg_id: int,
                         body: bytes) -> None:
        base, req = unwrap(body, ReqSearchGuild)
        sess = self._mid_session(base)
        guilds = self.game_world.guilds
        if sess is None or guilds is None:
            return
        needle = req.guild_name.decode("utf-8", "replace").lower()
        out = []
        for info in guilds.guilds.values():
            if needle and needle not in info.name.lower():
                continue
            out.append(SearchGuildObject(
                guild_ID=guid_ident(info.group_id),
                guild_name=info.name.encode(),
                guild_member_count=len(info.members),
                guild_member_max_count=info.capacity,
            ))
        self._send_to_session(sess, MsgID.ACK_SEARCH_GUILD,
                              AckSearchGuild(guild_list=out))

    # --------------------------------------------------------- GM + PVP
    def _on_gm_command(self, conn_id: int, _msg_id: int,
                       body: bytes) -> None:
        """EGMI_REQ_CMD_NORMAL (NFCGmModule::OnGMNormalProcess):
        ReqCommand's typed EGameCommandType mapped onto GmModule's
        chat-command grammar, so the GMLevel gate applies identically."""
        from ..wire import ReqCommand

        base, req = unwrap(body, ReqCommand)
        sess = self._mid_session(base)
        gm = self.game_world.gm
        if sess is None or gm is None:
            return
        k = self.kernel
        sval = (req.command_str_value or b"").decode("utf-8", "replace")
        ival = int(req.command_value_int or 0)
        cmd = int(req.command_id)
        if cmd == 0:  # EGCT_MODIY_PROPERTY: SET the named int property
            if int(k.get_property(sess.guid, "GMLevel")) < gm.min_gm_level:
                return
            spec = k.store.spec("Player")
            if sval and spec.has_property(sval) \
                    and spec.slot(sval).prop.type == DataType.INT:
                k.set_property(sess.guid, sval, ival)
            return
        text = {
            1: f"/item {sval} {ival or 1}",  # EGCT_MODIY_ITEM
            3: f"/exp {ival}",  # EGCT_ADD_ROLE_EXP
        }.get(cmd)
        if text is not None:
            gm.handle_command(sess.guid, text)

    def _on_pvp_apply(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        """EGMI_REQ_PVPAPPLYMACTCH (NFCGSPVPMatchModule shape): queue the
        player; when the score-window pairing matches two, BOTH get an
        ACK with the room (red/blue) and the role tracks it for the
        ectype step."""
        from ..wire import AckPVPApplyMatch, PVPRoomInfo, ReqPVPApplyMatch

        base, req = unwrap(body, ReqPVPApplyMatch)
        sess = self._mid_session(base)
        pvp = self.game_world.pvp
        if sess is None or pvp is None:
            return
        score = int(self.kernel.get_property(sess.guid, "Level")
                    if req.score is None else req.score)  # 0 is a real rating
        if not pvp.join_queue(sess.guid, score, mode=int(req.nPVPMode)):
            # already queued: re-apply means switch (new mode/score wins)
            pvp.leave_queue(sess.guid)
            pvp.join_queue(sess.guid, score, mode=int(req.nPVPMode))
        for ta, tb in pvp.match_once_tickets():
            red, blue = ta.player, tb.player
            room_id = self.kernel.store.guids.next()
            room = PVPRoomInfo(
                nCellStatus=0,
                RoomID=guid_ident(room_id),
                # the PAIR's queue mode — window-widening can match a
                # pair during someone else's request
                nPVPMode=ta.mode,
                MaxPalyer=2,
                xRedPlayer=[guid_ident(red)],
                xBluePlayer=[guid_ident(blue)],
                serverid=self.config.server_id,
            )
            self._pvp_rooms[(room_id.head, room_id.data)] = (red, blue)
            ack = AckPVPApplyMatch(xRoomInfo=room,
                                   ApplyType=int(req.ApplyType), nResult=1)
            for g in (red, blue):
                key = self._guid_session.get(g)
                s2 = self.sessions.get(key) if key is not None else None
                if s2 is not None:
                    ack.self_id = guid_ident(g)
                    self._send_to_session(s2, MsgID.ACK_PVP_APPLY_MATCH, ack)

    def _on_pvp_create_ectype(self, conn_id: int, _msg_id: int,
                              body: bytes) -> None:
        """EGMI_REQ_CREATEPVPECTYPE: mint the PVP instance — a CLONE
        scene group both fighters enter (the reference pulls both sides
        into the room's ectype scene)."""
        from ..wire import AckCreatePVPEctype, ReqCreatePVPEctype

        base, req = unwrap(body, ReqCreatePVPEctype)
        sess = self._mid_session(base)
        if sess is None or req.xRoomInfo is None or req.xRoomInfo.RoomID is None:
            return
        rid = (req.xRoomInfo.RoomID.svrid, req.xRoomInfo.RoomID.index)
        pair = self._pvp_rooms.get(rid)
        if pair is None or sess.guid not in pair:
            return  # unknown room, or a NON-participant: room stays live
        del self._pvp_rooms[rid]
        scene_id = int(req.xRoomInfo.SceneID or
                       self.kernel.get_property(sess.guid, "SceneID"))
        if scene_id not in self.scene.scenes:
            self.scene.create_scene(scene_id)
        # ONE shared instance for both fighters (scene_process.enter
        # would mint a private clone group per enterer)
        group = self.scene.request_group(scene_id)
        for g in pair:
            if g in self.kernel.store.guid_map:
                self.scene.enter_scene(g, scene_id, group)
        req.xRoomInfo.SceneID = scene_id
        req.xRoomInfo.groupID = group
        ack = AckCreatePVPEctype(xRoomInfo=req.xRoomInfo)
        for g in pair:
            key = self._guid_session.get(g)
            s2 = self.sessions.get(key) if key is not None else None
            if s2 is not None:
                ack.self_id = guid_ident(g)  # per-recipient, like apply
                self._send_to_session(s2, MsgID.ACK_CREATE_PVP_ECTYPE, ack)


    # ------------------------------------------------------------ SLG city
    # reference handlers: NFCSLGShopModule::OnSLGClienBuyItem and
    # NFCSLGBuildingModule::OnSLGClienMoveObject/UpgradeBuilding/CreateItem
    def _slg_session(self, base) -> Optional[Session]:
        sess = self.sessions.get(_ident_key(base.player_id))
        if sess is None or sess.guid is None:
            return None
        if self.game_world.slg_building is None:
            return None  # world assembled without the middleware stack
        return sess

    def _on_slg_buy(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        from ..wire_families import ReqAckBuyObjectFormShop

        base, req = unwrap(body, ReqAckBuyObjectFormShop)
        sess = self._slg_session(base)
        if sess is None:
            return
        shop_id = req.config_id.decode("utf-8", "replace")
        if self.game_world.slg_shop.buy(sess.guid, shop_id,
                                        req.x, req.y, req.z):
            self._send_to_session(sess, MsgID.ACK_BUY_FORM_SHOP, req)

    def _on_slg_move(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        from ..wire_families import ReqAckMoveBuildObject

        base, req = unwrap(body, ReqAckMoveBuildObject)
        sess = self._slg_session(base)
        if sess is None or req.row is None:
            return
        if self.game_world.slg_building.move(sess.guid, int(req.row),
                                             req.x, req.y, req.z):
            self._send_to_session(sess, MsgID.ACK_MOVE_BUILD_OBJECT, req)

    def _on_slg_upgrade(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        from ..wire_families import ReqUpBuildLv

        base, req = unwrap(body, ReqUpBuildLv)
        sess = self._slg_session(base)
        if sess is None or req.row is None:
            return
        self.game_world.slg_building.upgrade(sess.guid, int(req.row))

    def _on_slg_create_item(self, conn_id: int, _msg_id: int,
                            body: bytes) -> None:
        from ..wire_families import ReqCreateItem

        base, req = unwrap(body, ReqCreateItem)
        sess = self._slg_session(base)
        if sess is None or req.row is None:
            return
        self.game_world.slg_building.produce(
            sess.guid, int(req.row),
            req.config_id.decode("utf-8", "replace"), int(req.count) or 1,
        )

    def _on_slg_operate(self, conn_id: int, _msg_id: int, body: bytes) -> None:
        from ..wire_families import ReqBuildOperate, SLGFuncType

        base, req = unwrap(body, ReqBuildOperate)
        sess = self._slg_session(base)
        if sess is None or req.row is None:
            return
        b = self.game_world.slg_building
        ft = int(req.functype)
        collect = {
            int(SLGFuncType.COLLECT_GOLD): "Gold",
            int(SLGFuncType.COLLECT_STONE): "Stone",
            int(SLGFuncType.COLLECT_STEEL): "Steel",
            int(SLGFuncType.COLLECT_DIAMOND): "Diamond",
        }.get(ft)
        if collect is not None:
            b.collect(sess.guid, int(req.row), collect)
            return
        fn = {
            int(SLGFuncType.BOOST): b.boost,
            int(SLGFuncType.LVLUP): b.upgrade,
            int(SLGFuncType.CANCEL): b.cancel,
        }.get(ft)
        if fn is not None:
            fn(sess.guid, int(req.row))
